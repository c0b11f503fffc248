#!/usr/bin/env python
"""Smoke test of the renderer on one NVIDIA GPU, through its user entry
points, at the repo's bench sizes.

    python chip_smoke.py          # every single-card phase
    python chip_smoke.py --four   # the four-card phase only

Phases run in order in this one process; each prints its result and wall
time, and any failure makes the script exit non-zero without a result line.
The last line of a passing run is one JSON object naming the device.

  1 device      JAX's devices are GPUs (stop otherwise)
  2 headline    cli.main on cornell_tex.pbrt at 512², 64 spp, depth 5; the
                PNG decoded and checked (walls, emitter); the kernel image
                against brute on the card; the CPU golden config against
                tests/goldens/cornell.npy
  3 kernels     the Triton cluster kernels against the dense brute
                reference on mesh10k, mesh600k and spherefield10k (32k camera
                + 32k bounce rays; tools/traversal_bench.py)
  4 renders     mesh10k and spherefield10k through render_scene at their
                bench sizes, default intersector
  5 inverse     make_sharded_train_step on a 1-device mesh, textured
                Cornell: the loss falls, kernel gradients match brute
  6 four cards  (--four only) render_distributed on mesh10k over 4 cards
                against 1, and the 4-card train step against 1
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent
SCENES = REPO / "scenes"

# Tolerances (PERF.md, "Correctness on the card"). The kernel and brute
# paths, and the card and the CPU, differ only in FMA contraction and sum
# order, which flips rare grazing paths; a flipped path through the glass or
# the mirror can carry the emitter's radiance, so block and pixel checks
# leave room for a few of them while a wrong hit rule or a global shift of a
# few per cent still fails.
IMG_MEAN_REL = 2e-3  # whole-image mean, relative
BLOCK_REL = 5e-2  # 16×16-block means: |Δ| ≤ BLOCK_REL·mean + BLOCK_ABS
BLOCK_ABS = 5e-3
GOLDEN_MEAN_REL = 5e-2  # CPU golden (32², 4 spp) vs card: image mean
GOLDEN_ABS_REL = 0.25  # ... and mean |Δ| over the image mean (a mirrored or
# miscoloured image scores ~1)
GRAD_REL_L2 = 1e-2  # gradient leaves: ‖Δ‖₂ ≤ GRAD_REL_L2·‖ref‖₂ + GRAD_ATOL·√n
GRAD_ATOL = 1e-6  # (one texel seen by one flipped sample may differ fully)
DIST_MEAN_REL = 2e-3  # 4-card vs 1-card image

HEADLINE = dict(res=512, spp=64, depth=5)
KERNEL_SCENES = ("mesh10k", "mesh600k", "spherefield10k")
RENDER_CELLS = ("mesh10k_512", "spherefield10k_256")
FOUR_CARD_RENDER = {"resolution": (512, 512), "spp": 16, "max_depth": 8}  # mesh10k


def block_means(img, b=16):
    h, w = img.shape[0] // b * b, img.shape[1] // b * b
    x = img[:h, :w].reshape(h // b, b, w // b, b, -1)
    return x.mean(axis=(1, 3))


def compare_images(a, b, mean_rel=IMG_MEAN_REL):
    """→ (ok, stats): image means within mean_rel, 16×16-block means
    within BLOCK_REL·mean + BLOCK_ABS."""
    import numpy as np

    ma, mb = float(a.mean()), float(b.mean())
    ba, bb = block_means(a), block_means(b)
    excess = np.abs(ba - bb) - (BLOCK_REL * np.abs(bb) + BLOCK_ABS)
    stats = {
        "mean_a": ma, "mean_b": mb,
        "mean_rel": abs(ma - mb) / max(abs(mb), 1e-12),
        "block_max_abs": float(np.abs(ba - bb).max()),
        "blocks_over": int((excess > 0).sum()),
    }
    ok = stats["mean_rel"] <= mean_rel and stats["blocks_over"] == 0
    return ok, stats


def cornell_checks(img):
    """tests/test_golden.py's Cornell sanity, scaled to the image: red wall
    right, green wall left, emitter visible. img: (H, W, 3) floats or u8."""
    import numpy as np

    h, w = img.shape[:2]
    ys = slice(h * 24 // 64, h * 40 // 64)
    left = img[ys, w * 4 // 64:w * 12 // 64].reshape(-1, 3).mean(0)
    right = img[ys, w * 52 // 64:w * 60 // 64].reshape(-1, 3).mean(0)
    return {
        "red_right": bool(right[0] > 1.6 * right[1]),
        "green_left": bool(left[1] > 1.6 * left[0]),
        "finite": bool(np.isfinite(np.asarray(img, np.float64)).all()),
    }


def phase_device(four):
    import jax

    from curry_pbrt_tpu.utils.device import nvidia_smi_card

    devs = jax.devices()
    print(f"card: {nvidia_smi_card()}")
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {devs[0].platform!r}")
    need = 4 if four else 1
    if len(devs) < need:
        raise RuntimeError(f"{len(devs)} GPU(s); this run needs {need}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def phase_headline(tmp):
    import numpy as np
    import jax.numpy as jnp

    import bench
    from curry_pbrt_tpu import cli
    from curry_pbrt_tpu.ops import film as F
    from curry_pbrt_tpu.render import default_backend, render_scene
    from curry_pbrt_tpu.sceneio.compiler import compile_scene_file
    from curry_pbrt_tpu.utils.imageio import read_png

    out = {}
    png = tmp / "cornell_tex.png"
    args = [str(SCENES / "cornell_tex.pbrt"), "-o", str(png),
            "--res", str(HEADLINE["res"]), str(HEADLINE["res"]),
            "--spp", str(HEADLINE["spp"]), "--max-depth", str(HEADLINE["depth"]),
            "--quiet"]
    t0 = time.perf_counter()
    cli.main(args)
    out["cli_wall_s"] = time.perf_counter() - t0
    px = read_png(png)
    checks = {"emitter_visible": bool((px == 255).all(axis=-1).any())}
    checks["shape"] = px.shape == (HEADLINE["res"], HEADLINE["res"], 3)
    out["png_checks"] = checks

    res = HEADLINE["res"]
    scene = compile_scene_file(SCENES / "cornell_tex.pbrt", overrides={
        "resolution": (res, res), "spp": HEADLINE["spp"],
        "max_depth": HEADLINE["depth"]})
    out["default_intersector"] = default_backend(scene)
    img = {k: render_scene(scene, intersector=k, show_progress=False)
           for k in ("pallas", "brute")}
    ok_k, out["kernel_vs_brute"] = compare_images(img["pallas"], img["brute"])
    checks.update(cornell_checks(img["pallas"]))
    checks["emitter_float"] = bool(img["pallas"].max() > 5.0)
    brute_u8 = np.asarray(F.to_srgb_u8(jnp.asarray(img["brute"])), np.float32)
    ok_png, out["png_vs_brute_u8"] = compare_images(
        px.astype(np.float32), brute_u8, mean_rel=IMG_MEAN_REL)

    gold = np.load(REPO / "tests" / "goldens" / "cornell.npy")
    gscene = compile_scene_file(SCENES / "cornell.pbrt", overrides={
        "resolution": (32, 32), "spp": 4, "max_depth": 3})
    gimg = render_scene(gscene, show_progress=False)
    gm, cm = float(gold.mean()), float(gimg.mean())
    out["golden"] = {"cpu_mean": gm, "card_mean": cm,
                     "mean_rel": abs(cm - gm) / gm,
                     "abs_rel": float(np.abs(gimg - gold).mean()) / gm}
    ok_gold = (out["golden"]["mean_rel"] <= GOLDEN_MEAN_REL
               and out["golden"]["abs_rel"] <= GOLDEN_ABS_REL)

    r = bench.run_config("cornell_tex.pbrt", passes=1, **HEADLINE)
    out["bench_wall_s"] = r["wall_s"]
    out["seg_per_s"] = r["rays_per_sec"]
    ok = all(checks.values()) and ok_k and ok_png and ok_gold
    return ok, out


def phase_kernels():
    sys.path.insert(0, str(REPO / "tools"))
    import traversal_bench as tb

    from curry_pbrt_tpu.sceneio.compiler import compile_scene_file

    out, ok = {}, True
    for name in KERNEL_SCENES:
        scene = compile_scene_file(SCENES / f"{name}.pbrt")
        rays = tb.workload(scene)
        refs = {k: tb.brute_tprim(scene, *v) for k, v in rays.items()}
        r = tb.run_backend(scene, "pallas", rays, refs)
        ok &= r["ok"]
        out[name] = r
    return ok, out


def phase_renders():
    import numpy as np

    import bench
    from curry_pbrt_tpu.render import default_backend, render_scene
    from curry_pbrt_tpu.sceneio.compiler import compile_scene_file

    out, ok = {}, True
    for cell in RENDER_CELLS:
        cfg = bench.SECONDARY[cell][0]
        scene = compile_scene_file(SCENES / cfg["scene"], overrides={
            "resolution": (cfg["res"], cfg["res"]), "spp": cfg["spp"],
            "max_depth": cfg["depth"]})
        t0 = time.perf_counter()
        img = render_scene(scene, show_progress=False)
        first = time.perf_counter() - t0
        r = bench.run_config(passes=1, **cfg)
        good = bool(np.isfinite(img).all() and img.mean() > 1e-3)
        ok &= good
        out[cell] = {"intersector": default_backend(scene),
                     "render_scene_s": first, "bench_wall_s": r["wall_s"],
                     "seg_per_s": r["rays_per_sec"], "mean": float(img.mean()),
                     "ok": good}
    return ok, out


def _inverse_setup(res=64, spp=8, depth=3):
    import numpy as np
    import jax.numpy as jnp

    from curry_pbrt_tpu.render import _chunked_pixel_arrays, plan_render
    from curry_pbrt_tpu.sceneio.compiler import compile_scene_file

    scene = compile_scene_file(SCENES / "cornell_tex.pbrt", overrides={
        "resolution": (res, res), "spp": spp, "max_depth": depth})
    plans = {k: plan_render(scene, intersector=k, chunk_pixels=res * res)
             for k in ("pallas", "brute")}
    po, px, _ = _chunked_pixel_arrays(plans["pallas"])
    po, px = jnp.asarray(po[0]), jnp.asarray(px[0])
    start = dict(scene.init_params)
    start["textures"] = {k: v * 0.5 for k, v in start["textures"].items()}
    return scene, plans, po, px, start


def _texture_optimizer():
    import jax
    import optax

    return optax.masked(optax.adam(0.05), lambda p: jax.tree_util.tree_map_with_path(
        lambda path, _: getattr(path[0], "key", None) == "textures", p))


def _leaves_close(a, b):
    """Per-leaf match: ‖a − b‖₂ ≤ GRAD_REL_L2·‖b‖₂ + GRAD_ATOL·√n over the
    finite entries, with non-finite entries at the same places in both (the
    glass IOR gradient is NaN on the CPU too). → (matches, worst ratio of
    ‖a − b‖₂ to its bound)."""
    import numpy as np
    import jax

    match, worst = [], 0.0
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        fin = np.isfinite(x) & np.isfinite(y)
        bound = (GRAD_REL_L2 * np.linalg.norm(y[fin])
                 + GRAD_ATOL * np.sqrt(max(int(fin.sum()), 1)))
        ratio = float(np.linalg.norm((x - y)[fin]) / bound)
        worst = max(worst, ratio)
        match.append(ratio <= 1.0
                     and bool((np.isfinite(x) == np.isfinite(y)).all()))
    return match, worst


def phase_inverse():
    import numpy as np
    import jax
    import jax.numpy as jnp

    from curry_pbrt_tpu.parallel.mesh import make_mesh, make_sharded_train_step
    from curry_pbrt_tpu.render import _render_chunk

    scene, plans, po, px, params = _inverse_setup()
    target = _render_chunk(plans["pallas"], scene.init_params, po, px)
    opt = _texture_optimizer()
    step = make_sharded_train_step(plans["pallas"], make_mesh(1), opt)
    state = opt.init(params)
    losses = []
    t0 = time.perf_counter()
    for _ in range(8):
        params, state, loss = step(params, state, target, po, px)
        losses.append(float(loss))
    wall = time.perf_counter() - t0

    _s, _p, _po, _px, start = _inverse_setup()

    def grads(plan):
        def loss(p):
            return jnp.mean((_render_chunk(plan, p, po, px) - target) ** 2)
        return jax.jit(jax.grad(loss))(start)

    gk, gb = grads(plans["pallas"]), grads(plans["brute"])
    flat, worst = _leaves_close(gk, gb)
    tex = jax.tree_util.tree_leaves(gk["textures"])
    out = {"losses": losses, "steps_wall_s": wall,
           "grad_leaves_match": f"{sum(flat)}/{len(flat)}",
           "grad_worst_ratio": worst,
           "texture_grad_nonzero": bool(any(np.abs(np.asarray(t)).sum() > 0
                                            for t in tex))}
    ok = (losses[-1] < losses[0] and all(flat) and out["texture_grad_nonzero"]
          and all(np.isfinite(losses)))
    return ok, out


def phase_four(tmp):
    import numpy as np
    import jax
    import jax.numpy as jnp

    from curry_pbrt_tpu.parallel.mesh import make_mesh, make_sharded_train_step
    from curry_pbrt_tpu.parallel.multihost import render_distributed
    from curry_pbrt_tpu.render import _render_chunk, render_scene
    from curry_pbrt_tpu.sceneio.compiler import compile_scene_file

    out = {}
    ov = FOUR_CARD_RENDER
    t0 = time.perf_counter()
    img4 = render_distributed(SCENES / "mesh10k.pbrt", ov,
                              output=str(tmp / "mesh10k_4.png"))
    out["render_4_s"] = time.perf_counter() - t0
    scene = compile_scene_file(SCENES / "mesh10k.pbrt", overrides=ov)
    t0 = time.perf_counter()
    img1 = render_scene(scene, show_progress=False)
    out["render_1_s"] = time.perf_counter() - t0
    ok_img, out["four_vs_one"] = compare_images(img4, img1,
                                                mean_rel=DIST_MEAN_REL)

    scene, plans, po, px, start = _inverse_setup()
    target = _render_chunk(plans["pallas"], scene.init_params, po, px)
    opt = _texture_optimizer()
    res = {}
    for n in (1, 4):
        step = make_sharded_train_step(plans["pallas"], make_mesh(n), opt)
        p, _s, loss = step(start, opt.init(start), target, po, px)
        res[n] = (p, float(loss))
    match, worst = _leaves_close(res[4][0], res[1][0])
    out["train_loss_1_4"] = [res[1][1], res[4][1]]
    out["updated_params_match"] = f"{sum(match)}/{len(match)}"
    out["params_worst_ratio"] = worst
    ok = (ok_img and all(match)
          and abs(res[1][1] - res[4][1]) <= DIST_MEAN_REL * abs(res[1][1]))
    return ok, out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args(argv)
    if not (REPO / "curry_pbrt_tpu").is_dir():
        print(f"chip_smoke: no curry_pbrt_tpu package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import tempfile

    from curry_pbrt_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    t0 = time.perf_counter()
    try:
        device = phase_device(args.four)
    except (SystemExit, RuntimeError) as e:
        print(f"phase device: FAILED ({e})")
        return 1
    print(f"phase device: ok ({time.perf_counter() - t0:.1f} s) {device}")

    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        if args.four:
            phases = [("four cards", lambda: phase_four(tmp))]
        else:
            phases = [("headline", lambda: phase_headline(tmp)),
                      ("kernels", phase_kernels),
                      ("renders", phase_renders),
                      ("inverse", phase_inverse)]
        failed = []
        for name, fn in phases:
            t0 = time.perf_counter()
            try:
                ok, info = fn()
            except Exception:  # a phase's crash is that phase's failure
                traceback.print_exc()
                ok, info = False, "raised"
            wall = time.perf_counter() - t0
            print(f"phase {name}: {'ok' if ok else 'FAILED'} ({wall:.1f} s) "
                  f"{json.dumps(info, default=str)}", flush=True)
            if not ok:
                failed.append(name)
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
