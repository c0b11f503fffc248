#!/usr/bin/env python
"""Per-traversal check and timing of every intersector on one scene.

Workload: one 32k-ray chunk of camera rays through the middle rows of the
film, plus one bounce: each camera hit spawns a cosine-distributed
continuation ray (misses become dead lanes, t_max = 0, as in the
integrators). Per intersector it times closest-hit (t, prim) on both ray
sets and any-hit on the bounce rays, and checks each against the dense
brute reference, run in ray chunks so that no (rays × prims) buffer
exceeds 2^28 elements.

    python tools/traversal_bench.py scenes/mesh10k.pbrt [--backends pallas bvh brute]

Prints one JSON line per (scene, backend). Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from curry_pbrt_tpu.dtypes import FLOAT_MAX  # noqa: E402
from curry_pbrt_tpu.models.camera import generate_rays  # noqa: E402
from curry_pbrt_tpu.ops import intersect as isect  # noqa: E402
from curry_pbrt_tpu.render import make_shade_context  # noqa: E402

N_RAYS = 1 << 15
MAX_PAIRS = 1 << 28
# tolerances (PERF.md): hit/miss, t and prim agreement on >= 99.9 % of rays
REL_T = 1e-5
MAX_BAD_FRACTION = 1e-3
SWEEP_GRID = [(br, bt, w) for br in (32, 64, 128) for bt in (16, 32, 64)
              for w in (4, 8)]


def workload(scene, n_rays=N_RAYS, seed=0):
    """{"camera": (o, d, t_max), "bounce": (o, d, t_max)} device arrays."""
    rng = np.random.default_rng(seed)
    xres, yres = scene.settings.resolution
    first = max((xres * yres - n_rays) // 2, 0)
    pix = (first + np.arange(n_rays)) % (xres * yres)
    film_xy = np.stack([pix % xres, pix // xres], -1).astype(np.float32)
    film_xy += rng.uniform(0.0, 1.0, film_xy.shape).astype(np.float32) - 0.5
    o, d = generate_rays(scene.camera, jnp.asarray(film_xy))
    t_max = jnp.full((n_rays,), FLOAT_MAX)
    hit = brute_hit(scene, o, d, t_max)
    n = np.asarray(hit.n)
    # cosine-distributed direction about the shading normal, flipped to
    # the side the camera ray came from
    u1, u2 = rng.uniform(size=(2, n_rays))
    r, phi = np.sqrt(u1), 2 * np.pi * u2
    local = np.stack([r * np.cos(phi), r * np.sin(phi), np.sqrt(1 - u1)], -1)
    n = np.where((np.sum(n * np.asarray(d), -1) > 0)[:, None], -n, n)
    a = np.where(np.abs(n[:, :1]) > 0.9, [[0.0, 1.0, 0.0]], [[1.0, 0.0, 0.0]])
    tx = np.cross(a, n)
    tx /= np.maximum(np.linalg.norm(tx, axis=-1, keepdims=True), 1e-12)
    ty = np.cross(n, tx)
    nd = (local[:, :1] * tx + local[:, 1:2] * ty + local[:, 2:] * n)
    nd = jnp.asarray(nd.astype(np.float32))
    bo, bd = isect.spawn_ray(hit.p, jnp.asarray(n, jnp.float32), hit.p_error, nd)
    alive = np.asarray(hit.prim) >= 0
    bt = jnp.where(jnp.asarray(alive), FLOAT_MAX, 0.0)
    return {"camera": (o, d, t_max), "bounce": (bo, bd, bt)}


def _ray_chunks(scene):
    n_prims = max(scene.tris.count + scene.spheres.count, 1)
    return max(1, 1 << int(np.floor(np.log2(max(MAX_PAIRS // n_prims, 1)))))


def brute_hit(scene, o, d, t_max) -> isect.Hit:
    """Dense reference hit, in ray chunks."""
    fn = jax.jit(lambda o, d, t: isect.intersect_brute(
        o, d, t, tris=scene.tris, sph=scene.spheres))
    return _chunked(fn, _ray_chunks(scene), o, d, t_max)


def brute_tprim(scene, o, d, t_max):
    fn = jax.jit(lambda o, d, t: isect.intersect_tprim_brute(
        o, d, t, tris=scene.tris, sph=scene.spheres))
    return _chunked(fn, _ray_chunks(scene), o, d, t_max)


def _chunk_fn(fn, c):
    return lambda o, d, t_max: _chunked(fn, c, o, d, t_max)


def _chunked(fn, c, o, d, t_max):
    n = o.shape[0]
    c = min(c, n)
    pad = (-n) % c
    o, d = (jnp.pad(x, ((0, pad), (0, 0))) for x in (o, d))
    t_max = jnp.pad(t_max, (0, pad))
    outs = [fn(o[i:i + c], d[i:i + c], t_max[i:i + c])
            for i in range(0, n + pad, c)]
    return jax.tree_util.tree_map(lambda *xs: jnp.concatenate(xs)[:n], *outs)


def compare(got, ref) -> dict:
    """Agreement of (t, prim) results: a ray is bad when hit/miss differs,
    when |Δt| > REL_T·t where both hit, or when the prim differs and the
    two t lie further apart than that (two hits within Δt are a tie)."""
    t, p = (np.asarray(x) for x in got)
    rt, rp = (np.asarray(x) for x in ref)
    hit, rhit = p >= 0, rp >= 0
    both = hit & rhit
    close = np.abs(t - rt) <= REL_T * np.abs(rt)
    bad = (hit != rhit) | (both & ~close)
    n = len(p)
    return {
        "rays": n,
        "hit_agree": float(np.mean(hit == rhit)),
        "t_bad": int(np.sum(both & ~close)),
        "prim_differs": int(np.sum(both & (p != rp))),
        "bad_fraction": float(np.sum(bad)) / n,
        "ok": bool(np.sum(bad) <= MAX_BAD_FRACTION * n),
    }


def timed(fn, *args, reps=5) -> float:
    """Median wall seconds of fn(*args) after a compile + warm call."""
    jax.block_until_ready(fn(*args))
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls)


def run_backend(scene, backend, rays, refs, with_timing=True):
    """Check one intersector against the brute references; time it."""
    t0 = time.perf_counter()
    ctx = make_shade_context(scene, backend)
    out = {"backend": backend, "build_s": time.perf_counter() - t0}
    tprim = jax.jit(ctx.intersect_tprim)
    pred = jax.jit(ctx.predicate)
    if backend == "brute":  # bounded (rays × prims) buffers, as a render's chunks
        c = _ray_chunks(scene)
        tprim = _chunk_fn(tprim, c)
        pred = _chunk_fn(pred, c)
    for name, (o, d, t_max) in rays.items():
        out[f"{name}_check"] = compare(tprim(o, d, t_max), refs[name])
    bo, bd, bt = rays["bounce"]
    got_any = np.asarray(pred(bo, bd, bt))
    ref_any = np.asarray(refs["bounce"][1]) >= 0
    out["any_hit_bad"] = int(np.sum(got_any != ref_any))
    out["ok"] = (all(out[f"{n}_check"]["ok"] for n in rays)
                 and out["any_hit_bad"] <= MAX_BAD_FRACTION * len(ref_any))
    if with_timing:
        for name, (o, d, t_max) in rays.items():
            out[f"{name}_closest_s"] = timed(tprim, o, d, t_max)
        out["bounce_any_s"] = timed(pred, bo, bd, bt)
    return out


def sweep(scene, rays, refs, grid):
    """Time the triangle kernel at each (block_r, block_t, num_warps) of
    grid on the scene's triangles: closest-hit on both ray sets, any-hit
    on the bounce rays, each variant checked like run_backend."""
    from curry_pbrt_tpu.ops.pallas import intersect_kernel as ik

    tris = scene.tris
    cam = np.asarray(scene.camera.camera_to_world)[:3, 3]
    tables = {}
    for block_r, block_t, warps in grid:
        if block_t not in tables:
            tables[block_t] = ik.build_tri_tables(
                tris.p0, tris.p1, tris.p2, tris.prim, block_t=block_t,
                view_origin=cam)
        tab = tables[block_t]
        args = tuple(jnp.asarray(a) for a in (
            tab.tri_rows, tab.cluster_aabbs, tab.super_aabbs, tab.slab_aabbs))
        tr = ik.Traversal(ik._tri_tile_test, ik.TRI_ROWS, block_t,
                          tab.clusters_per_slab, tab.n_slabs, tab.use_supers,
                          block_r, warps)
        prim = jnp.asarray(tab.prim)
        kw = dict(interpret=ik.interpret_mode())
        closest = jax.jit(lambda o, d, t: ik.run_traversal(
            tr, o, d, t, *args, any_hit=False, **kw))
        anyhit = jax.jit(lambda o, d, t: ik.run_traversal(
            tr, o, d, t, *args, any_hit=True, **kw))
        r = {"block_r": block_r, "block_t": block_t, "num_warps": warps}
        for name, (o, d, t_max) in rays.items():
            t, idx = closest(o, d, t_max)
            p = jnp.where(idx >= 0, prim[jnp.clip(idx, 0)], -1)
            r[f"{name}_ok"] = compare((t, p), refs[name])["ok"]
            r[f"{name}_closest_s"] = timed(closest, o, d, t_max)
        r["bounce_any_s"] = timed(anyhit, *rays["bounce"])
        yield r


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("scenes", nargs="+")
    ap.add_argument("--backends", nargs="+", default=["pallas", "bvh", "brute"])
    ap.add_argument("--sweep", nargs="*", metavar="BR,BT,WARPS",
                    help="time the triangle kernel over these block sizes "
                         "(default: the full grid) instead")
    args = ap.parse_args(argv)

    from curry_pbrt_tpu.sceneio.compiler import compile_scene_file
    from curry_pbrt_tpu.utils.cache import enable_compile_cache
    from curry_pbrt_tpu.utils.device import device_record, require_gpu

    require_gpu("tools/traversal_bench.py")
    enable_compile_cache()
    dev = device_record()
    ok = True
    for path in args.scenes:
        scene = compile_scene_file(path)
        rays = workload(scene)
        refs = {k: brute_tprim(scene, *v) for k, v in rays.items()}
        if args.sweep is not None:
            grid = [tuple(map(int, g.split(","))) for g in args.sweep]
            for r in sweep(scene, rays, refs, grid or SWEEP_GRID):
                r.update(scene=Path(path).name)
                print(json.dumps(r), flush=True)
            continue
        for backend in args.backends:
            r = run_backend(scene, backend, rays, refs)
            r.update(scene=Path(path).name, device=dev)
            ok &= r["ok"]
            print(json.dumps(r), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
