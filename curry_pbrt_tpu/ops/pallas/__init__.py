"""Pallas kernels (Triton on the GPU) — the hand-scheduled tier under ops/.

Kernels here exist where XLA's own code measures slower end to end
(PERF.md); everything has a pure-jnp reference implementation in ops/ that
the tests compare against (same math, same masking: in interpret mode on
the CPU, and within PERF.md's tolerances on the GPU).
"""

from curry_pbrt_tpu.ops.pallas.intersect_kernel import (  # noqa: F401
    tri_closest_hit_pallas,
    tri_any_hit_pallas,
)
from curry_pbrt_tpu.ops.pallas.aggregate import (  # noqa: F401
    make_pallas_intersectors,
)
