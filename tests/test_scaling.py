"""Scaling harness assertions on the 8-virtual-CPU-device mesh.

On virtual devices all 'chips' share the host's cores, so throughput cannot
scale; what IS measurable is sharding OVERHEAD: the N-device shard_map render
of the same total workload vs the single-device wall. The assertion bound is
an efficiency proxy of 0.65 — a structural-regression tripwire, NOT the
config-5 ≥0.80 target, which is measured on real chips with
tools/scaling_bench.py (see the in-test comment for why the proxy loosens as
the renderer gets faster).
"""

import statistics
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from curry_pbrt_tpu.parallel.mesh import make_mesh, make_sharded_render
from curry_pbrt_tpu.render import plan_render
from curry_pbrt_tpu.sceneio.compiler import compile_scene_file
from pathlib import Path

CORNELL = Path(__file__).resolve().parents[1] / "scenes" / "cornell.pbrt"
RES, SPP, DEPTH = 256, 8, 3


def _timed_render(n_devices, scene, passes=6):
    xres, yres = scene.settings.resolution
    n_pixels = xres * yres
    pad = (-n_pixels) % n_devices
    plan = plan_render(scene, chunk_pixels=n_pixels + pad)
    mesh = make_mesh(n_devices)
    render = make_sharded_render(plan, mesh)
    ys, xs = np.mgrid[0:yres, 0:xres]
    px = np.pad(np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32),
                ((0, pad), (0, 0)))
    po = np.pad(plan.pixel_offsets.reshape(-1), (0, pad))
    po_j, px_j = jnp.asarray(po), jnp.asarray(px)
    out = render(scene.init_params, po_j, px_j)
    img = np.asarray(out)[:n_pixels]
    walls = []
    for _ in range(passes):
        t0 = time.perf_counter()
        out = render(scene.init_params, po_j, px_j)
        _ = float(jnp.sum(out))
        walls.append(time.perf_counter() - t0)
    # min, not median: CI shares the host with other work, and transient
    # load inflates individual passes (observed 2× spikes); the fastest
    # clean pass is the sharding overhead being measured
    return min(walls), img


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharding_efficiency_proxy_above_065():
    scene = compile_scene_file(
        CORNELL, overrides={"resolution": (RES, RES), "spp": SPP, "max_depth": DEPTH}
    )
    wall_1, img_1 = _timed_render(1, scene)
    wall_8, img_8 = _timed_render(8, scene)
    # device-count-invariant image up to last-ULP: per-device slab shapes
    # differ (16384 vs 2048 rows), which changes XLA's FMA fusion choices
    np.testing.assert_allclose(img_1, img_8, atol=1e-7)
    efficiency = wall_1 / wall_8
    overhead = wall_8 - wall_1
    # Two complementary bounds:
    #   ratio >= 0.65 — structural-regression tripwire (e.g. an accidental
    #     cross-device collective in the forward path). The ratio is
    #     sensitive to absolute speed: shard_map's per-call overhead is
    #     fixed, so every renderer speedup shrinks it with no real scaling
    #     regression (0.87 when first written, ~0.74 after round 3).
    #   absolute overhead <= 2.0 s — the quantity the ratio proxies: extra
    #     wall added by 8-way sharding of the SAME total workload. It does
    #     NOT loosen as the renderer gets faster (measured ~0.9-1.4 s on an
    #     otherwise-idle 2-core host). The real >=0.80 config-5 target is
    #     measured on chips with tools/scaling_bench.py.
    assert efficiency >= 0.65, (
        f"8-way sharding overhead too high: wall_1={wall_1:.3f}s "
        f"wall_8={wall_8:.3f}s (efficiency proxy {efficiency:.2f} < 0.65)"
    )
    assert overhead <= 2.0, (
        f"8-way sharding ABSOLUTE overhead too high: wall_1={wall_1:.3f}s "
        f"wall_8={wall_8:.3f}s (+{overhead:.2f}s > 2.0s budget)"
    )
