#!/usr/bin/env python
"""Per-stage profiling of the headline bench workload (SURVEY §5 scope:
"jax.profiler traces + per-stage timing").

Times each wavefront stage in isolation on the bench scene (Cornell 512²,
64 spp, depth 5) with representative inputs, so the end-to-end wall time can
be attributed: Halton sampling, camera rays, closest-hit intersect, shadow
predicate, shading eval/sample, NEE, film accumulate, and the full render.

Usage:
  python tools/profile_bench.py [--trace DIR]   # --trace also dumps a
                                                # jax.profiler trace viewable
                                                # in TensorBoard/Perfetto
"""

import argparse
import json
import sys
import time
from functools import partial
from pathlib import Path


REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from curry_pbrt_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np
import jax
import jax.numpy as jnp


def timeit(name, fn, *args, n=3):
    """Compile + best-of-n wall time for a jitted fn."""
    out = fn(*args)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    print(f"{name:40s} {best*1e3:10.2f} ms")
    return name, best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default=None, help="jax.profiler trace output dir")
    ap.add_argument("--rays", type=int, default=1 << 20)
    ap.add_argument("--scene", default=str(REPO / "scenes" / "cornell.pbrt"))
    ap.add_argument("--intersector", default=None)
    args = ap.parse_args()

    from curry_pbrt_tpu.sceneio.compiler import compile_scene_file
    from curry_pbrt_tpu.render import plan_render, _render_chunk, _chunked_pixel_arrays
    from curry_pbrt_tpu.models.camera import generate_rays
    from curry_pbrt_tpu.models import integrators as I
    from curry_pbrt_tpu.ops.halton import halton_sample, halton_indices
    from curry_pbrt_tpu.ops import film as F
    from curry_pbrt_tpu.ops import math as m

    scene = compile_scene_file(
        args.scene, overrides={"resolution": (512, 512), "spp": 64, "max_depth": 5}
    )
    plan = plan_render(scene, intersector=args.intersector)
    ctx = plan.ctx
    params = scene.init_params
    N = args.rays
    print(f"platform={jax.default_backend()}  N={N}  scene={Path(args.scene).name}")

    # representative inputs
    po, px, n_pixels = _chunked_pixel_arrays(plan)
    po0, px0 = jnp.asarray(po[0]), jnp.asarray(px[0])
    spp = scene.settings.spp
    offs = jnp.repeat(po0, spp)[:N]
    sample_idx = jnp.tile(jnp.arange(spp, dtype=jnp.uint32), (po0.shape[0],))[:N]
    indices = jax.jit(partial(halton_indices, cfg=plan.cfg))(offs, sample_idx)

    film_xy = jnp.repeat(px0, spp, axis=0)[:N]
    o, d = jax.jit(partial(generate_rays, scene.camera))(film_xy, None)
    o, d = jax.block_until_ready((o, d))
    t_max = jnp.full((N,), jnp.float32(3.0e38))

    results = {}

    def rec(name, fn, *a, **kw):
        k, v = timeit(name, fn, *a, **kw)
        results[k] = v

    # --- stage timings
    n_bounce_dims = 8 * scene.settings.max_depth

    @jax.jit
    def all_halton(idx):
        outs = [
            halton_sample(idx, plan.dim_base + k, plan.cfg, plan.perms)
            for k in range(n_bounce_dims)
        ]
        return jnp.stack(outs)

    rec(f"halton x{n_bounce_dims} dims", all_halton, indices)

    @jax.jit
    def one_halton_small(idx):
        return halton_sample(idx, plan.dim_base, plan.cfg, plan.perms)

    @jax.jit
    def one_halton_big(idx):
        return halton_sample(idx, plan.dim_base + n_bounce_dims - 1, plan.cfg, plan.perms)

    rec("halton 1 dim (small base)", one_halton_small, indices)
    rec("halton 1 dim (largest base)", one_halton_big, indices)

    rec("camera rays", jax.jit(partial(generate_rays, scene.camera)), film_xy, None)

    rec("intersect closest", jax.jit(ctx.intersect), o, d, t_max)
    rec("predicate (shadow)", jax.jit(ctx.predicate), o, d, t_max)

    # shading-only: fabricate a hit batch from real intersections
    hit = jax.jit(ctx.intersect)(o, d, t_max)
    hit = jax.block_until_ready(hit)
    mat_ids = jnp.asarray(np.asarray(ctx.prim_mat))[jnp.maximum(hit.prim, 0)]
    mat_ids = jnp.where(hit.prim >= 0, mat_ids, -1)
    fx, fy, fz = m.coordinate_system(hit.n)[0], m.coordinate_system(hit.n)[1], hit.n
    wo_l = m.to_local(-d, fx, fy, fz)
    u1 = halton_sample(indices, 4, plan.cfg, plan.perms)
    u2 = halton_sample(indices, 5, plan.cfg, plan.perms)

    @jax.jit
    def shade_eval_only(uv, wo_l, wi_l):
        fl = I.build_family_lobes(ctx, mat_ids, uv, params)
        return I.shade_eval(ctx, fl, mat_ids, wo_l, wi_l)

    rec("shade_eval (all mats)", shade_eval_only, hit.uv, wo_l, wo_l)

    @jax.jit
    def shade_sample_only(uv, wo_l, ub, ue):
        fl = I.build_family_lobes(ctx, mat_ids, uv, params)
        return I.shade_sample(ctx, fl, mat_ids, wo_l, ub, ue)

    rec("shade_sample (all mats)", shade_sample_only, hit.uv, wo_l, u1, u2)

    @jax.jit
    def nee_only(p_params, u1, u2):
        u = {
            "light_pick": u1, "light_u": u1, "light_v": u2,
            "nee_u": u2, "nee_v": u1, "bsdf_bucket": u2, "bsdf_extra": u1, "rr": u2,
        }
        frame = (fx, fy, fz)
        return I.uniform_sample_one_light(ctx, p_params, hit, mat_ids, -d, frame, u)

    rec("NEE (light+bsdf strategies)", nee_only, params, u1, u2)

    @jax.jit
    def path_full(p_params, o, d, idx):
        return I.path_trace(
            ctx, p_params, o, d, idx, plan.cfg, plan.perms,
            scene.settings.max_depth, plan.dim_base,
        )

    rec("path_trace (1 chunk)", path_full, params, o, d, indices)

    rec(
        "render chunk e2e",
        jax.jit(partial(_render_chunk, plan)),
        params, po0, px0,
    )

    if args.trace:
        with jax.profiler.trace(args.trace):
            out = jax.jit(partial(_render_chunk, plan))(params, po0, px0)
            jax.block_until_ready(out)
        print(f"trace written to {args.trace}")

    print(json.dumps({k: round(v * 1e3, 2) for k, v in results.items()}))


if __name__ == "__main__":
    main()
