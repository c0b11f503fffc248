#!/usr/bin/env python
"""End-to-end render walls behind the intersector and chunk-size choices.

    python tools/render_sweep.py intersectors chunks

  intersectors  every bench cell (bench.py) with each intersector that
                fits the device: the data behind render.default_backend
  chunks        the headline and mesh10k at 32k, 128k, 512k and 1M rays
                per chunk: the data behind render.CHUNK_RAYS

Prints one JSON line per render (bench.run_config's fields). Needs a GPU.
"""

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import bench  # noqa: E402

CELLS = {"cornell_tex_512_headline": bench.HEADLINE,
         **{k: v[0] for k, v in bench.SECONDARY.items()
            if k != "mesh10k_1024_full"}}
# brute's dense buffers cannot hold the big meshes' rays × triangles
INTERSECTORS = {
    "cornell_tex_512_headline": ("pallas", "brute", "bvh"),
    "spheres_direct_256": ("pallas", "brute", "bvh"),
    "mesh10k_512": ("pallas", "bvh", "brute"),
    "spherefield10k_256": ("pallas", "bvh", "brute"),
    "mesh600k_256": ("pallas", "bvh"),
    "mesh100k_512": ("pallas", "bvh"),
}
CHUNK_RAYS = (1 << 15, 1 << 17, 1 << 19, 1 << 20)


def emit(tag, cfg, passes=2, **kw):
    r = bench.run_config(passes=passes, **dict(cfg, **kw))
    r.update(experiment=tag, cell_config=cfg)
    print(json.dumps(r), flush=True)


def intersectors(*only):
    """only: "cell:intersector" pairs to run (default: all)."""
    # every cell's kernel render first, then the plain versions
    for rank in range(3):
        for name, order in INTERSECTORS.items():
            if rank < len(order) and (not only or f"{name}:{order[rank]}" in only):
                emit(f"intersectors/{name}", CELLS[name],
                     intersector=order[rank])


def chunks(*_only):
    from curry_pbrt_tpu.render import default_backend
    from curry_pbrt_tpu.sceneio.compiler import compile_scene_file

    for name in ("cornell_tex_512_headline", "mesh10k_512"):
        cfg = CELLS[name]
        sc = compile_scene_file(REPO / "scenes" / cfg["scene"])
        backend = default_backend(sc)
        for rays in CHUNK_RAYS:
            emit(f"chunks/{name}/{rays}", cfg, passes=1, intersector=backend,
                 chunk_pixels=rays // cfg["spp"])


def main(argv):
    from curry_pbrt_tpu.utils.cache import enable_compile_cache
    from curry_pbrt_tpu.utils.device import device_record, require_gpu

    require_gpu("tools/render_sweep.py")
    enable_compile_cache()
    print(json.dumps({"device": device_record()}), flush=True)
    experiments = {"intersectors": intersectors, "chunks": chunks}
    names = [a for a in argv if a in experiments]
    only = [a for a in argv if a not in experiments]  # cell/intersector filters
    for name in names or list(experiments):
        experiments[name](*only)


if __name__ == "__main__":
    main(sys.argv[1:])
