#!/usr/bin/env python
"""Scaling-efficiency harness (BASELINE config 5: ≥80% rays/s efficiency at
1 chip / 1 host / ≥2 hosts).

Runs the same fixed workload on meshes of 1/2/4/… devices and reports
per-size wall + rays/s + efficiency. Two regimes:

  * real GPUs: efficiency_N = rays_s_N / (N · rays_s_1) — the true
    scaling number for BENCH records;
  * virtual host devices (CPU, --xla_force_host_platform_device_count):
    all "devices" share the same cores, so throughput can't scale; the
    meaningful number is SHARDING OVERHEAD — efficiency_N = wall_1 / wall_N
    (≥0.8 ⇔ shard_map/psum adds ≤25% to the same total work).

Usage:  python tools/scaling_bench.py [--scene cornell.pbrt] [--res 128]
          [--spp 8] [--devices 1 2 4 8] [--cpu]
Prints one JSON line.
"""

import argparse
import json
import os
import statistics
import sys
import time
from functools import partial
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="cornell.pbrt")
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--devices", type=int, nargs="+", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="force an 8-way virtual CPU device platform")
    ap.add_argument("--passes", type=int, default=3)
    args = ap.parse_args()

    if args.cpu:
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8"
            ).strip()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from curry_pbrt_tpu.parallel.mesh import make_mesh, make_sharded_render
    from curry_pbrt_tpu.render import plan_render
    from curry_pbrt_tpu.sceneio.compiler import compile_scene_file

    n_avail = len(jax.devices())
    sizes = args.devices or [n for n in (1, 2, 4, 8) if n <= n_avail]
    virtual = jax.default_backend() == "cpu"

    scene = compile_scene_file(
        REPO / "scenes" / args.scene,
        overrides={"resolution": (args.res, args.res), "spp": args.spp,
                   "max_depth": args.depth},
    )
    xres, yres = scene.settings.resolution
    n_pixels = xres * yres
    rays = n_pixels * args.spp

    results = {}
    for n in sizes:
        pad = (-n_pixels) % n
        plan = plan_render(scene, chunk_pixels=n_pixels + pad)
        mesh = make_mesh(n)
        render = make_sharded_render(plan, mesh)
        ys, xs = np.mgrid[0:yres, 0:xres]
        px = np.pad(
            np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32),
            ((0, pad), (0, 0)),
        )
        po = np.pad(plan.pixel_offsets.reshape(-1), (0, pad))
        po_j, px_j = jnp.asarray(po), jnp.asarray(px)
        out = render(scene.init_params, po_j, px_j)
        checksum = float(jnp.sum(out))  # fetch = sync
        walls = []
        for _ in range(args.passes):
            t0 = time.perf_counter()
            out = render(scene.init_params, po_j, px_j)
            _ = float(jnp.sum(out))
            walls.append(time.perf_counter() - t0)
        wall = statistics.median(walls)
        results[n] = {
            "wall_s": round(wall, 4),
            "rays_per_sec": round(rays / wall, 1),
            "checksum": round(checksum, 2),
        }

    base = results[sizes[0]]
    for n in sizes:
        if virtual:
            eff = base["wall_s"] / results[n]["wall_s"]
        else:
            eff = results[n]["rays_per_sec"] / (
                n / sizes[0] * base["rays_per_sec"]
            )
        results[n]["efficiency"] = round(eff, 3)

    print(json.dumps({
        "mode": "virtual-cpu-overhead" if virtual else "real-chip-scaling",
        "workload": {"scene": args.scene, "res": args.res, "spp": args.spp,
                     "depth": args.depth},
        "devices": results,
    }))
    # determinism across device counts
    sums = {results[n]["checksum"] for n in sizes}
    if len(sums) != 1:
        print(f"WARNING: checksum varies with device count: {sums}",
              file=sys.stderr)


if __name__ == "__main__":
    main()
