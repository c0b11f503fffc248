#!/usr/bin/env python
"""Bisect uniform_sample_one_light's 19ms/rep on the bench scene."""

import sys, time
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
from curry_pbrt_tpu.ops import math as m
from curry_pbrt_tpu.ops.intersect import offset_point_by_error
from curry_pbrt_tpu.dtypes import FLOAT_MAX, Float

N = 1 << 20
K1, K2 = 4, 12


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
    def run(k):
        @jax.jit
        def go(c):
            return jax.lax.fori_loop(0, k, lambda i, c: body(c), c)

        return wall(go, init)

    t1, t2 = run(K1), run(K2)
    print(f"{name:44s} {(t2 - t1) / (K2 - K1) * 1e3:9.3f} ms/rep")


scene = compile_scene_file(
    REPO / "scenes" / "cornell.pbrt",
    overrides={"resolution": (512, 512), "spp": 64, "max_depth": 5},
)
plan = plan_render(scene)
ctx, params = plan.ctx, scene.init_params
print(f"n_lights={ctx.n_lights} envs={len(ctx.envs)}")

key = jax.random.PRNGKey(0)
o = jax.random.uniform(key, (N, 3), Float) * 500.0
d = jax.random.normal(key, (N, 3), Float)
d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
hit = jax.jit(ctx.intersect)(o, d, jnp.full((N,), FLOAT_MAX))
hit = jax.block_until_ready(hit)
mat_ids = jnp.asarray(np.asarray(ctx.prim_mat))[jnp.maximum(hit.prim, 0)]
mat_ids = jnp.where(hit.prim >= 0, mat_ids, -1)
fx, fy = m.coordinate_system(hit.n)
frame = (fx, fy, hit.n)
wo = -d
wo_l = m.to_local(wo, fx, fy, hit.n)
u1 = jax.random.uniform(key, (N,), Float)
light_L = params["light_L"]
p, n, perr, uv = hit.p, hit.n, hit.p_error, hit.uv


def dep(u, x):
    return jnp.clip(u + 1e-7 * x, 0.0, 1.0)


# piece 1: light pick + sample_li
def piece_pick(u):
    lf = u * Float(ctx.n_lights)
    li = jnp.minimum(lf.astype(jnp.int32), ctx.n_lights - 1)
    ls = LT.sample_li(ctx.lights, ctx.envs, light_L, li, p, n, perr,
                      jnp.stack([u, 1.0 - u], axis=-1))
    return dep(u, ls.pdf)

per_rep("sample_li", piece_pick, u1)

lf = u1 * Float(ctx.n_lights)
light_idx = jnp.minimum(lf.astype(jnp.int32), ctx.n_lights - 1)
ls = LT.sample_li(ctx.lights, ctx.envs, light_L, light_idx, p, n, perr,
                  jnp.stack([u1, 1.0 - u1], axis=-1))
ls = jax.block_until_ready(ls)
chosen_delta = m.take_small(jnp.asarray(ctx.lights.is_delta), light_idx)


# piece 2: light-strategy shading+shadow
def piece_light_strat(u):
    wi_l = m.to_local(ls.wi, fx, fy, hit.n)
    fl = I.build_family_lobes(ctx, mat_ids, uv, params)
    f, f_pdf, f_pres = I.shade_eval(ctx, fl, mat_ids, wo_l, wi_l)
    occluded = ctx.predicate(ls.vis_o, ls.vis_d, ls.vis_tmax)
    cos_term = jnp.abs(m.dot(n, ls.wi))
    w = jnp.where(chosen_delta, 1.0, m.power_heuristic(ls.pdf, f_pdf))
    ld = ls.li * f * (cos_term * w / jnp.where(ls.pdf == 0, 1.0, ls.pdf))[:, None]
    ok = ls.present & (ls.pdf != 0) & f_pres & (f_pdf != 0) & ~occluded
    return dep(u, jnp.where(ok, ld[:, 0], 0.0))

per_rep("light strategy (eval+shadow+weights)", piece_light_strat, u1)


# piece 3: bsdf-strategy
def piece_bsdf_strat(u):
    fl = I.build_family_lobes(ctx, mat_ids, uv, params)
    wi2_l, f2, f2_pdf, f2_pres = I.shade_sample_nondelta(ctx, fl, mat_ids, wo_l, u, u)
    wi2 = m.to_world(wi2_l, fx, fy, hit.n)
    o2 = offset_point_by_error(p, n, perr, wi2)
    hit2 = ctx.intersect(o2, wi2, jnp.full((N,), FLOAT_MAX))
    hit2_light = m.take_small(jnp.asarray(np.asarray(ctx.prim_light)), jnp.maximum(hit2.prim, 0))
    hit2_light = jnp.where(hit2.prim >= 0, hit2_light, -1)
    same = (hit2_light >= 0) & (hit2_light == light_idx)
    li2 = LT.le_emitted(light_L, jnp.where(same, light_idx, -1))
    li2_pdf = LT.le_pdf(ctx.lights, jnp.where(same, light_idx, -1), p, hit2.p, hit2.n)
    return dep(u, li2[:, 0] + li2_pdf)

per_rep("bsdf strategy (sample+isect+le_pdf)", piece_bsdf_strat, u1)


# piece 3a: le_pdf alone
hit2 = jax.block_until_ready(jax.jit(ctx.intersect)(o, d, jnp.full((N,), FLOAT_MAX)))

def piece_lepdf(u):
    li2_pdf = LT.le_pdf(ctx.lights, light_idx, p, hit2.p, hit2.n)
    return dep(u, li2_pdf)

per_rep("le_pdf alone", piece_lepdf, u1)


# piece 3b: intersect from offset origins
def piece_isect2(u):
    o2 = offset_point_by_error(p, n, perr, ls.wi)
    h = ctx.intersect(o2, ls.wi, jnp.full((N,), FLOAT_MAX))
    return dep(u, h.t)

per_rep("offset+intersect", piece_isect2, u1)


# piece 4: full NEE for reference
def piece_full(u):
    us = {k: u for k in ("light_pick", "light_u", "light_v", "nee_u",
                         "nee_v", "bsdf_bucket", "bsdf_extra", "rr")}
    nee = I.uniform_sample_one_light(ctx, params, hit, mat_ids, wo, frame, us)
    return dep(u, nee[:, 0])

per_rep("full NEE", piece_full, u1)
