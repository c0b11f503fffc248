#!/usr/bin/env python
"""Benchmark suite. Prints ONE JSON line; headline fields first:

  {"metric": "rays_per_sec_per_chip", "value": N, "unit": "rays/s",
   "vs_baseline": R, "device": {...}, "timing": {...}, "configs": {...}}

Headline (BASELINE config 3): textured Cornell 512², 64 spp, depth-5 path
trace. rays/sec/chip = total traced path segments (camera + bounce
closest-hits + NEE shadow + NEE MIS rays over active lanes) ÷ wall time ÷
chips, fixed seeds. Every config reports the same segments-based unit
(directlighting included — its NEE shadow + MIS rays count too).

Every cell runs in this one process on one GPU, with the intersector that
render.default_backend picks for it. Timing methodology (recorded in the
JSON): one warm-up pass (compile included, reported as warmup_s), then
PASSES timed passes, each ended by block_until_ready, MEDIAN reported.
Every result names the device it ran on. vs_baseline ratios compare
against this same renderer on a host CPU, captured with the same
per-config protocol via `python bench.py --capture-cpu-baseline` (cached
in baseline_cpu.json with provenance).

Configs:
  cornell_tex_512_headline  BASELINE config 3 (the headline metric)
  spheres_direct_256        config 2: spheres.pbrt 256², 16 spp, directlighting
  mesh10k_512               config-5 workload at 512², 16 spp, depth 8
  mesh10k_1024_full         config 5 AS SPECIFIED: 1024², 256 spp, depth 8
                            (2 timed passes). vs_baseline uses the
                            mesh10k_512 CPU rate (same scene/unit).
  mesh100k_512              hierarchy benchmark (100k triangles)
  mesh600k_256              620k triangles
  spherefield10k_256        10k-sphere field through the sphere cluster
                            kernel
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
BASELINE_CACHE = REPO / "baseline_cpu.json"

HEADLINE = dict(scene="cornell_tex.pbrt", res=512, spp=64, depth=5)
PASSES = 5

# secondary configs: name -> (run_config kwargs, timed passes, baseline key)
SECONDARY = {
    "spheres_direct_256": (
        dict(scene="spheres.pbrt", res=256, spp=16, depth=0,
             integrator="directlighting"),
        PASSES, "spheres_direct_256",
    ),
    "mesh10k_512": (
        dict(scene="mesh10k.pbrt", res=512, spp=16, depth=8),
        PASSES, "mesh10k_512",
    ),
    "mesh100k_512": (
        dict(scene="mesh100k.pbrt", res=512, spp=16, depth=8),
        2, "mesh100k_256r",  # CPU pass at 256²/4spp — same scene/depth,
        # same seg/s unit; full 512²/16spp would be ~75 min on this host
    ),
    "mesh600k_256": (
        dict(scene="mesh600k.pbrt", res=256, spp=4, depth=5),
        2, "mesh600k_128r",  # CPU pass at 128²/2spp (same scene/depth/unit)
    ),
    "spherefield10k_256": (
        # no same-protocol CPU rate for this cell
        dict(scene="spherefield10k.pbrt", res=256, spp=4, depth=3),
        3, None,
    ),
    # LAST: the longest cell — if an external timeout cuts the bench
    # short, the cheap configs are already recorded
    "mesh10k_1024_full": (
        dict(scene="mesh10k.pbrt", res=1024, spp=256, depth=8),
        2, "mesh10k_512",  # full-size CPU pass would take hours; same unit
    ),
}

# configs captured on the CPU backend for vs_baseline ratios. The two *r
# entries are reduced-scale protocols for the big-mesh scenes: identical scene/depth/intersector kwargs, reduced res/spp so a
# CPU pass is minutes, compared through the resolution-independent seg/s
# rate (the protocol mesh10k_1024_full already uses).
CPU_BASELINE_CONFIGS = {
    "headline": (HEADLINE, PASSES),
    "spheres_direct_256": (SECONDARY["spheres_direct_256"][0], PASSES),
    "mesh10k_512": (SECONDARY["mesh10k_512"][0], 1),  # ~2 min/pass on CPU
    "mesh100k_256r": (
        dict(scene="mesh100k.pbrt", res=256, spp=4, depth=8),
        1,
    ),
    "mesh600k_128r": (
        dict(scene="mesh600k.pbrt", res=128, spp=2, depth=5),
        1,
    ),
}


def _build(scene, res, spp, depth, integrator=None, intersector=None,
           chunk_pixels=None):
    import jax
    import jax.numpy as jnp
    from curry_pbrt_tpu.models.materials import with_family_tables
    from curry_pbrt_tpu.sceneio.compiler import compile_scene_file
    from curry_pbrt_tpu.render import (
        plan_render,
        _render_chunk_stats,
        _chunked_pixel_arrays,
    )

    overrides = {"resolution": (res, res) if isinstance(res, int) else res,
                 "spp": spp, "max_depth": depth}
    if integrator:
        overrides["integrator"] = integrator
    sc = compile_scene_file(REPO / "scenes" / scene, overrides=overrides)
    plan = plan_render(sc, intersector=intersector, chunk_pixels=chunk_pixels)
    po_np, px_np, _ = _chunked_pixel_arrays(plan)
    params = with_family_tables(plan.ctx.families, sc.init_params)

    def render_all(params, po, px):
        imgs, segs = jax.lax.map(
            lambda c: _render_chunk_stats(plan, params, c[0], c[1]), (po, px)
        )
        return jnp.sum(imgs), jnp.sum(segs)

    fn = jax.jit(render_all)
    po, px = jnp.asarray(po_np), jnp.asarray(px_np)
    return fn, params, po, px, sc


def run_config(scene, res, spp, depth, integrator=None, intersector=None,
               passes=None, chunk_pixels=None):
    """→ dict with wall (median), segments, rays/s."""
    import jax
    from curry_pbrt_tpu.render import MAX_CHUNKS_PER_DISPATCH, default_backend

    passes = PASSES if passes is None else passes
    t_setup = time.perf_counter()
    fn, params, po, px, sc = _build(scene, res, spp, depth, integrator,
                                    intersector, chunk_pixels)
    k = po.shape[0]
    if k > MAX_CHUNKS_PER_DISPATCH:
        # group size = the largest divisor of k within the dispatch cap, so
        # padding chunks never exist — a padding chunk would re-render pixel
        # (0,0) and its traced segments would inflate rays_per_sec
        g = next(gg for gg in range(MAX_CHUNKS_PER_DISPATCH, 0, -1)
                 if k % gg == 0)
        groups = [(po[i * g:(i + 1) * g], px[i * g:(i + 1) * g])
                  for i in range(k // g)]
    else:
        groups = [(po, px)]

    def full_pass():
        outs = [fn(params, gpo, gpx) for gpo, gpx in groups]
        jax.block_until_ready(outs)
        return (sum(float(s) for s, _ in outs),
                sum(float(seg) for _, seg in outs))

    # warm-up: compile + one pass. Grouped configs warm on the first group
    # only: it compiles and warms the executable the other groups reuse.
    t0 = time.perf_counter()
    jax.block_until_ready(fn(params, *groups[0]))
    warm = time.perf_counter() - t0
    setup = t0 - t_setup
    walls = []
    for _ in range(passes):
        t0 = time.perf_counter()
        checksum, segments = full_pass()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    xres, yres = sc.settings.resolution
    camera_rays = xres * yres * sc.settings.spp
    out = {
        "intersector": intersector or default_backend(sc),
        "chunk_pixels": int(po.shape[1]),
        "setup_s": setup,
        "warmup_s": warm,
        "wall_s": wall,
        "walls_s": walls,
        "camera_rays": camera_rays,
        "camera_rays_per_sec": camera_rays / wall,
        "checksum": checksum,
    }
    if segments > 0:
        out["segments"] = segments
        out["rays_per_sec"] = segments / wall
    return out


def capture_cpu_baseline(only_missing=True):
    """Run the baseline configs on the CPU backend in subprocesses and cache
    rates with provenance (same renderer, same per-config protocol).

    By default configs already present in the cache are kept as-is (the
    mesh10k pass alone is ~12 min); --recapture-cpu-baseline redoes all."""
    import platform

    entries = {}
    cached = cpu_baseline() or {}
    for name, (kw, passes) in CPU_BASELINE_CONFIGS.items():
        if only_missing and name in cached.get("configs", {}):
            entries[name] = cached["configs"][name]
            print(f"{name}: cached ({entries[name].get('rays_per_sec', 0):.0f} rays/s)",
                  file=sys.stderr)
            continue
        code = (
            "import os, json, sys;"
            f"sys.path.insert(0, {str(REPO)!r});"
            "import jax; jax.config.update('jax_platforms', 'cpu');"
            "from bench import run_config;"
            f"print('CPU_RESULT ' + json.dumps(run_config(passes={passes}, **{kw!r})))"
        )
        res = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO
        )
        line = [l for l in res.stdout.splitlines() if l.startswith("CPU_RESULT ")]
        if not line:
            sys.stderr.write(res.stdout + res.stderr)
            raise SystemExit(f"CPU baseline run failed for {name}")
        data = json.loads(line[0][len("CPU_RESULT "):])
        entries[name] = {"rays_per_sec": data.get("rays_per_sec"), "detail": data,
                         "config": kw, "passes": passes,
                         "captured_unix": int(time.time())}
        print(f"{name}: {data.get('rays_per_sec', 0):.0f} rays/s (CPU)",
              file=sys.stderr)

    payload = {
        # legacy top-level field = headline rate (r3 compatibility)
        "rays_per_sec": entries["headline"]["rays_per_sec"],
        "configs": entries,
        "provenance": {
            "backend": "cpu (XLA, all host cores)",
            "host": platform.node(),
            "cpu_count": os.cpu_count(),
            "config": HEADLINE,
            "protocol": f"1 warm-up + per-config passes, median",
            "captured_unix": int(time.time()),
        },
    }
    BASELINE_CACHE.write_text(json.dumps(payload, indent=1))
    print(f"wrote {BASELINE_CACHE}", file=sys.stderr)
    return payload


def cpu_baseline():
    if BASELINE_CACHE.exists():
        return json.loads(BASELINE_CACHE.read_text())
    return None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--capture-cpu-baseline", action="store_true")
    ap.add_argument("--recapture-cpu-baseline", action="store_true",
                    help="redo every baseline config, ignoring the cache")
    ap.add_argument("--skip-secondary", action="store_true",
                    help="headline config only")
    ap.add_argument("--skip-full", action="store_true",
                    help="skip the minutes-long mesh10k_1024_full config")
    args = ap.parse_args()

    if args.capture_cpu_baseline or args.recapture_cpu_baseline:
        capture_cpu_baseline(only_missing=not args.recapture_cpu_baseline)
        return

    from curry_pbrt_tpu.utils.cache import enable_compile_cache
    from curry_pbrt_tpu.utils.device import device_record, require_gpu

    require_gpu("bench.py")
    enable_compile_cache()
    device = device_record()
    head = run_config(**HEADLINE)
    base = cpu_baseline()
    base_cfgs = (base or {}).get("configs", {})

    def base_rate(key):
        if key is None:
            return None
        e = base_cfgs.get(key)
        if e:
            return e["rays_per_sec"]
        return (base or {}).get("rays_per_sec") if key == "headline" else None

    rps = head["rays_per_sec"]
    head_base = base_rate("headline")
    configs = {"cornell_tex_512_headline": head}
    if head_base:
        head["vs_baseline"] = rps / head_base

    if not args.skip_secondary:
        for name, (kw, passes, bkey) in SECONDARY.items():
            if args.skip_full and name == "mesh10k_1024_full":
                continue
            r = run_config(passes=passes, **kw)
            br = base_rate(bkey)
            if br and "rays_per_sec" in r:
                r["vs_baseline"] = r["rays_per_sec"] / br
                if bkey != name:
                    r["vs_baseline_note"] = f"vs CPU {bkey} rate (same scene/unit)"
            configs[name] = r
    for r in configs.values():
        r["device"] = device

    result = {
        "metric": "rays_per_sec_per_chip",
        "value": rps,
        "unit": "rays/s",
        "vs_baseline": rps / head_base if head_base else None,
        "device": device,
        "timing": {
            "warmup_passes": 1,
            "timed_passes": PASSES,
            "aggregation": "median",
            "sync": "block_until_ready",
            "baseline_protocol": "identical per config (see baseline_cpu.json)",
        },
        "configs": configs,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
