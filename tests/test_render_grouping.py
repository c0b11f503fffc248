"""Dispatch grouping + chunk sizing: grouped whole-film rendering must be
bit-identical to single-dispatch, and high-spp configs must keep their
per-intersector ray target (a 256-PIXEL floor would double it at 256
spp)."""

from pathlib import Path

import numpy as np

import curry_pbrt_tpu.render as R
from curry_pbrt_tpu.sceneio.compiler import compile_scene_file

SCENES = Path(__file__).resolve().parents[1] / "scenes"


def test_grouped_render_matches_single_dispatch(monkeypatch):
    sc = compile_scene_file(
        SCENES / "cornell.pbrt",
        overrides={"resolution": (32, 32), "spp": 2, "max_depth": 2},
    )
    img1 = R.render_scene(sc, show_progress=False, chunk_pixels=64)  # 16 chunks
    monkeypatch.setattr(R, "MAX_CHUNKS_PER_DISPATCH", 5)  # 4 groups, padded
    img2 = R.render_scene(sc, show_progress=False, chunk_pixels=64)
    np.testing.assert_array_equal(img1, img2)


def test_chunk_floor_is_rays_not_pixels(monkeypatch):
    # at a 32k-ray target and 256 spp a chunk is 128 pixels — the floor
    # must not push it to 256 pixels
    monkeypatch.setitem(R.CHUNK_RAYS, "pallas", 32768)
    sc = compile_scene_file(
        SCENES / "cornell.pbrt",
        overrides={"resolution": (1024, 1024), "spp": 256, "max_depth": 1},
    )
    plan = R.plan_render(sc, intersector="pallas")
    assert plan.chunk_pixels * 256 <= 32768
    # tiny scenes never exceed their own pixel count
    sc2 = compile_scene_file(
        SCENES / "cornell.pbrt",
        overrides={"resolution": (16, 16), "spp": 2, "max_depth": 1},
    )
    assert R.plan_render(sc2).chunk_pixels <= 16 * 16
