"""Multi-host orchestration.

The reference's only cross-machine story is an rsync+ssh script
(/root/reference/script/deploy.sh). The replacement is JAX's
multi-controller runtime: one process per host drives all of that host's
GPUs, `jax.distributed.initialize` joins the processes, the global mesh
spans every GPU of every host, and the film rows each process renders land
in its local shards; process 0 gathers and writes the PNG.

Launch (one command per host, or via your scheduler):

    python -m curry_pbrt_tpu.parallel.multihost scene.pbrt \
        --coordinator=host0:8476 --num-processes=2 --process-id=$ID
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np


def initialize(coordinator: Optional[str], num_processes: int, process_id: int):
    import jax

    if num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    return jax


def render_distributed(scene_path, overrides=None, coordinator=None,
                       num_processes=1, process_id=0, output=None):
    """Render with rays sharded over every device of every process.

    Multi-controller semantics: every process compiles the same scene and
    the same program. The film is cut into groups of (devices × the plan's
    chunk) pixels, so per-device memory stays at one chunk's working set
    whatever the film size; each group's pixel inputs become GLOBAL sharded
    arrays (each process materializes only its devices' rows via
    make_array_from_callback), and the per-process output rows are
    allgathered so every process holds the full film; process 0 writes the
    PNG."""
    jax = initialize(coordinator, num_processes, process_id)
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from curry_pbrt_tpu.parallel.mesh import make_mesh, make_sharded_render
    from curry_pbrt_tpu.render import plan_render
    from curry_pbrt_tpu.sceneio.compiler import compile_scene_file
    from curry_pbrt_tpu.ops import film as F
    from curry_pbrt_tpu.utils.imageio import write_png

    scene = compile_scene_file(scene_path, overrides)
    n_dev = len(jax.devices())
    xres, yres = scene.settings.resolution
    n_pixels = xres * yres

    plan = plan_render(scene)
    group = min(plan.chunk_pixels, -(-n_pixels // n_dev)) * n_dev
    n_groups = -(-n_pixels // group)
    pad = n_groups * group - n_pixels
    mesh = make_mesh()
    render = make_sharded_render(plan, mesh)

    ys, xs = np.mgrid[0:yres, 0:xres]
    px_np = np.pad(
        np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32), ((0, pad), (0, 0))
    )
    po_np = np.pad(plan.pixel_offsets.reshape(-1), (0, pad))
    shard = NamedSharding(mesh, P("rays"))
    shard2 = NamedSharding(mesh, P("rays", None))
    parts = []
    for g in range(n_groups):
        sl = slice(g * group, (g + 1) * group)
        po_g, px_g = po_np[sl], px_np[sl]
        po = jax.make_array_from_callback(po_g.shape, shard, lambda i: po_g[i])
        px = jax.make_array_from_callback(px_g.shape, shard2, lambda i: px_g[i])
        out = render(scene.init_params, po, px)
        # this process's contiguous rows, allgathered across processes
        shards = sorted(out.addressable_shards, key=lambda s: s.index[0].start or 0)
        rows = np.concatenate([np.asarray(s.data) for s in shards], axis=0)
        if num_processes > 1:
            from jax.experimental import multihost_utils

            rows = np.asarray(multihost_utils.process_allgather(rows, tiled=True))
        parts.append(rows)
    img = np.concatenate(parts)[:n_pixels].reshape(yres, xres, 3)
    if process_id == 0:
        path = output or scene.settings.filename
        write_png(path, np.asarray(F.to_srgb_u8(jnp.asarray(img))))
        print(path)
    return img


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("scene")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("--spp", type=int)
    args = ap.parse_args(argv)
    overrides = {} if args.spp is None else {"spp": args.spp}
    render_distributed(
        args.scene, overrides, args.coordinator, args.num_processes,
        args.process_id, args.output,
    )


if __name__ == "__main__":
    main()
