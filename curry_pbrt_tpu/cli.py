"""Command-line interface.

`python -m curry_pbrt_tpu.cli scene.pbrt` mirrors the reference CLI
(/root/reference/examples/render_from_file.rs: one positional scene path,
prints the output filename), plus standard overrides the reference lacked
(spp / resolution / depth / integrator / intersector / seed).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="curry-pbrt-tpu",
        description="pbrt-dialect path tracer on a GPU (JAX/Pallas)"
    )
    ap.add_argument("scene", help="pbrt scene file")
    ap.add_argument("-o", "--output", help="output PNG path (default: scene Film filename)")
    ap.add_argument("--spp", type=int, help="samples per pixel override")
    ap.add_argument("--res", type=int, nargs=2, metavar=("X", "Y"), help="resolution override")
    ap.add_argument("--max-depth", type=int, help="path depth override")
    ap.add_argument("--integrator", choices=["path", "directlighting"])
    ap.add_argument("--filter", choices=["box", "triangle"],
                    help="reconstruction filter override")
    ap.add_argument(
        "--intersector", choices=["brute", "bvh", "pallas"], help="force a backend"
    )
    ap.add_argument("--seed", type=int, default=0, help="sampler scramble seed")
    ap.add_argument("--no-clip", action="store_true", help="disable camera frustum culling")
    ap.add_argument("--chunk-pixels", type=int, help="pixels per device batch")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    overrides = {"seed": args.seed}
    if args.spp is not None:
        overrides["spp"] = args.spp
    if args.res is not None:
        overrides["resolution"] = tuple(args.res)
    if args.max_depth is not None:
        overrides["max_depth"] = args.max_depth
    if args.integrator is not None:
        overrides["integrator"] = args.integrator
    if args.filter is not None:
        overrides["filter"] = args.filter
    if args.no_clip:
        overrides["clip"] = False

    from curry_pbrt_tpu.render import render_from_file
    from curry_pbrt_tpu.utils.cache import enable_compile_cache
    from curry_pbrt_tpu.utils.device import require_render_device

    require_render_device()
    enable_compile_cache()
    render_from_file(
        args.scene,
        output=args.output,
        overrides=overrides,
        intersector=args.intersector,
        chunk_pixels=args.chunk_pixels,
        show_progress=not args.quiet,
    )


if __name__ == "__main__":
    main()
