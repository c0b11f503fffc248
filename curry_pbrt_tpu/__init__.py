"""curry_pbrt_tpu — a differentiable wavefront path tracer for GPUs.

Built from scratch in JAX/XLA/Pallas with the capabilities of the reference
CPU renderer (curry-pbrt): pbrt scene dialect, spheres/triangle meshes/PLY,
SAH BVH, 7 material families, 4 light families, Halton sampling, MIS NEE
path tracing — re-architected as batched SoA wavefront rendering sharded
over device meshes, with differentiable pixels.
"""

__version__ = "0.1.0"

# GPU matmuls may run f32 contractions in TF32 (~1e-3 relative); the
# ray/geometry transforms are tiny 3/4-wide contractions where that rounding
# corrupts shadow-ray origins into self-occlusion. Geometry needs full f32 —
# there are no large matmuls in this workload where TF32 would buy
# throughput.
import jax as _jax

_jax.config.update("jax_default_matmul_precision", "highest")


def __getattr__(name):
    # lazy to keep `import curry_pbrt_tpu.ops.math` cheap and cycle-free
    if name in ("render_from_file", "render_scene"):
        from curry_pbrt_tpu import render

        return getattr(render, name)
    raise AttributeError(name)
