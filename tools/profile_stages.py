#!/usr/bin/env python
"""In-dispatch per-stage timing, robust to per-dispatch host noise.

Each stage is repeated K times inside ONE jitted fori_loop with a data
dependency between iterations (so XLA cannot collapse them), for two values
of K; the cost per repetition is (T_K2 - T_K1) / (K2 - K1). This attributes
the bench render's wall time to stages without trusting per-dispatch walls.
"""

import os, sys, time
from functools import partial
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from curry_pbrt_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np
import jax
import jax.numpy as jnp

from curry_pbrt_tpu.sceneio.compiler import compile_scene_file
from curry_pbrt_tpu.render import plan_render
from curry_pbrt_tpu.models import integrators as I
from curry_pbrt_tpu.models import lights as LT
from curry_pbrt_tpu.ops import bsdf as B
from curry_pbrt_tpu.ops import math as m
from curry_pbrt_tpu.ops.halton import halton_sample
from curry_pbrt_tpu.ops.intersect import offset_point_by_error
from curry_pbrt_tpu.dtypes import FLOAT_MAX, Float

N = int(os.environ.get("PROFILE_N", 1 << 20))
# small-N stages need many reps to clear per-dispatch host jitter
K1 = int(os.environ.get("PROFILE_K1", 4))
K2 = int(os.environ.get("PROFILE_K2", 12))


def wall(fn, *args):
    out = fn(*args)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best


def per_rep(name, body, init):
    """body: carry -> carry. Returns per-repetition seconds."""

    def run(k):
        @jax.jit
        def go(c):
            return jax.lax.fori_loop(0, k, lambda i, c: body(c), c)

        return wall(go, init)

    t1, t2 = run(K1), run(K2)
    ms = (t2 - t1) / (K2 - K1) * 1e3
    print(f"{name:44s} {ms:9.3f} ms/rep")
    return ms


def main():
    scene = compile_scene_file(
        REPO / "scenes" / os.environ.get("PROFILE_SCENE", "cornell.pbrt"),
        overrides={"resolution": (512, 512), "spp": 64, "max_depth": 5},
    )
    plan = plan_render(scene)
    ctx, params, cfg, perms = plan.ctx, scene.init_params, plan.cfg, plan.perms
    print(f"platform={jax.default_backend()} N={N}")

    key = jax.random.PRNGKey(0)
    o = jax.random.uniform(key, (N, 3), Float) * 500.0
    d = jax.random.normal(key, (N, 3), Float)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    idx = jnp.arange(N, dtype=jnp.uint32)

    # --- intersect (carry: origins perturbed by hit t)
    def isect_body(c):
        o, d = c
        hit = ctx.intersect(o, d, jnp.full((N,), FLOAT_MAX))
        return o + 1e-6 * hit.t[:, None], d

    per_rep("intersect closest", isect_body, (o, d))

    def pred_body(c):
        o, d = c
        occ = ctx.predicate(o, d, jnp.full((N,), FLOAT_MAX))
        return o + 1e-6 * occ[:, None].astype(Float), d

    per_rep("predicate", pred_body, (o, d))

    # --- halton: one bounce's 8 dims
    def halton_body(c):
        i = c
        us = [halton_sample(i, 4 + k, cfg, perms) for k in range(8)]
        return i + (us[0] > 2.0).astype(jnp.uint32)  # never true; dep only

    per_rep("halton 8 dims", halton_body, idx)

    # --- shading pieces on a fixed hit batch
    hit = jax.jit(ctx.intersect)(o, d, jnp.full((N,), FLOAT_MAX))
    hit = jax.block_until_ready(hit)
    mat_ids = jnp.asarray(np.asarray(ctx.prim_mat))[jnp.maximum(hit.prim, 0)]
    mat_ids = jnp.where(hit.prim >= 0, mat_ids, -1)
    fx, fy = m.coordinate_system(hit.n)
    frame = (fx, fy, hit.n)
    wo = -d
    wo_l = m.to_local(wo, fx, fy, hit.n)
    u1 = jax.random.uniform(key, (N,), Float)

    def shade_eval_body(c):
        wi_l = c
        fl = I.build_family_lobes(ctx, mat_ids, hit.uv, params)
        f, pdf, pres = I.shade_eval(ctx, fl, mat_ids, wo_l, wi_l)
        return m.normalize(wi_l + 1e-6 * f)

    per_rep("shade_eval", shade_eval_body, wo_l)

    def shade_sample_nd_body(c):
        u = c
        fl = I.build_family_lobes(ctx, mat_ids, hit.uv, params)
        wi, f, pdf, pres = I.shade_sample_nondelta(ctx, fl, mat_ids, wo_l, u, u)
        return jnp.clip(u + 1e-7 * pdf, 0.0, 1.0)

    per_rep("shade_sample_nondelta", shade_sample_nd_body, u1)

    def shade_sample_body(c):
        u = c
        fl = I.build_family_lobes(ctx, mat_ids, hit.uv, params)
        wi, f, pdf, pres, isd = I.shade_sample(ctx, fl, mat_ids, wo_l, u, u)
        return jnp.clip(u + 1e-7 * pdf, 0.0, 1.0)

    per_rep("shade_sample (full)", shade_sample_body, u1)

    # --- light sampling alone
    def light_body(c):
        u = c
        lf = u * Float(ctx.n_lights)
        li = jnp.minimum(lf.astype(jnp.int32), ctx.n_lights - 1)
        ls = LT.sample_li(
            ctx.lights, ctx.envs, params["light_L"], li, hit.p, hit.n,
            hit.p_error, jnp.stack([u, 1.0 - u], axis=-1),
        )
        return jnp.clip(u + 1e-7 * ls.pdf, 0.0, 1.0)

    per_rep("light sample_li", light_body, u1)

    # --- full NEE
    def nee_body(c):
        u = c
        us = {k: u for k in ("light_pick", "light_u", "light_v", "nee_u",
                             "nee_v", "bsdf_bucket", "bsdf_extra", "rr")}
        nee = I.uniform_sample_one_light(ctx, params, hit, mat_ids, wo, frame, us)
        return jnp.clip(u + 1e-7 * nee[:, 0], 0.0, 1.0)

    per_rep("NEE total", nee_body, u1)

    # --- full bounce body approximation: emission+NEE+sample+offset
    def bounce_body(c):
        o2, d2, u = c
        hit2 = ctx.intersect(o2, d2, jnp.full((N,), FLOAT_MAX))
        mi = jnp.asarray(np.asarray(ctx.prim_mat))[jnp.maximum(hit2.prim, 0)]
        mi = jnp.where(hit2.prim >= 0, mi, -1)
        fx2, fy2 = m.coordinate_system(hit2.n)
        fr = (fx2, fy2, hit2.n)
        us = {k: u for k in ("light_pick", "light_u", "light_v", "nee_u",
                             "nee_v", "bsdf_bucket", "bsdf_extra", "rr")}
        nee = I.uniform_sample_one_light(ctx, params, hit2, mi, -d2, fr, us)
        wo_l2 = m.to_local(-d2, fx2, fy2, hit2.n)
        fl2 = I.build_family_lobes(ctx, mi, hit2.uv, params)
        wi, f, pdf, pres, isd = I.shade_sample(ctx, fl2, mi, wo_l2, u, u)
        wiw = m.to_world(wi, fx2, fy2, hit2.n)
        o3 = offset_point_by_error(hit2.p, hit2.n, hit2.p_error, wiw)
        return o3, m.normalize(wiw + 1e-6 * nee), jnp.clip(u + 1e-7 * pdf, 0.0, 1.0)

    per_rep("full bounce (isect+NEE+sample)", bounce_body, (o, d, u1))


if __name__ == "__main__":
    main()
