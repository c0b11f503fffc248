"""Pallas (Triton) kernel: hierarchical cluster-culled ray–primitive
closest-hit and any-hit, written for a GPU's ray-block programs.

Culling hierarchy (contrast the reference's recursive per-ray BVH,
aggregate/bvh.rs:151-190):

  level 0  primitives are pre-sorted into blocked kd cells so each
           block_t-sized contiguous run is spatially tight; every run
           carries a precomputed AABB ("cluster"). Before testing a
           cluster the program slab-tests its block_r rays against the
           AABB with each ray's CURRENT best t and skips the tile math
           (`lax.cond`) when no ray of the block can enter.
  level 1  SUPER_G consecutive clusters form a "super-cluster" with its own
           AABB; one slab test skips all SUPER_G children. Enabled beyond
           USE_SUPERS_MIN clusters.
  level 2  clusters are grouped into slabs of clusters_per_slab, each with
           an AABB: the top of the hierarchy, tested once per slab.

The grid covers ray blocks only. Each program owns block_r rays, walks
slabs → supers → clusters in loops inside the kernel, keeps the best
(t, idx) (or the any-hit flags) as loop-carried values, and writes them
once at the end, so no state passes between programs and they may run in
any order. Host-side, supers are ordered front-to-back from the camera and
clusters front-to-back within each super (the cluster-level analog of the
reference BVH's near-child-first traversal, bvh.rs:174-178), so early hits
tighten t and cull what lies behind them. Any-hit programs stop as soon as
every ray of the block has hit.

The per-tile triangle math is the reference's watertight test
(translate–permute–shear + edge functions + conservative fp-error
rejection, geometry/shape/triangle.rs:194-262 / pbrt §3.9), the same
operations as ops/intersect.py:watertight_core. The sphere kernel
(sphere_kernel.py) reuses the traversal with its own tile test.

Data layout: every table is column-major — one row per attribute, one
column per ray or primitive — so a program's loads are contiguous runs:
  rays:  (RAY_ROWS, N_pad) f32 — rows 0-2 origin, 3-5 shear sx/sy/sz,
         6 t_max, 7 dominant axis kz, 8-10 inv_d (slab test), 11-13 raw
         direction (sphere tile test).
  tris:  (TRI_ROWS, T_pad) f32 — rows 0-8 p0/p1/p2, 9 valid flag (±1).
  cluster/super/slab AABBs: (rows, 8) f32 — bmin xyz, bmax xyz. Empty
         boxes are NaN: every slab comparison with NaN is false, so they
         are never entered.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from curry_pbrt_tpu.dtypes import FLOAT_MAX, Float, gamma

_G2 = Float(gamma(2))
_G3 = Float(gamma(3))
_G5 = Float(gamma(5))
_T_SCALE = Float(1.0 + 2.0 * gamma(3))  # conservative slab widening (bounds.rs:303-323)

RAY_ROWS = 14
TRI_ROWS = 10
BLOCK_R = 32  # rays per program
BLOCK_T = 32  # triangles per cluster
SUPER_G = 8  # clusters per super-cluster (level-1 fan-out)
SLAB_CLUSTERS = 256  # clusters per slab (level 2)
USE_SUPERS_MIN = 96  # enable the super-cluster level beyond this many clusters
NUM_WARPS = 4  # Triton launch shape of one program
NUM_STAGES = 1


def interpret_mode() -> bool:
    """Whether Pallas kernels run in interpret mode on the current backend.

    The CPU has no compiled Pallas route, so the kernels are interpreted
    there (the test platform). On a GPU they compile through Triton. Any
    other platform is refused rather than silently interpreted."""
    backend = jax.default_backend()
    if backend == "cpu":
        return True
    if backend == "gpu":
        return False
    raise RuntimeError(f"no compiled Pallas route for backend {backend!r}")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _check_pow2(name: str, v: int) -> None:
    if v < 1 or v & (v - 1):
        raise ValueError(f"{name} must be a power of two (Triton block), got {v}")


def pack_rays(o, d, t_max, block_r: int = BLOCK_R) -> jnp.ndarray:
    """(N,3),(N,3),(N,) → (RAY_ROWS, N_pad) f32 with shear + inv_d
    precomputed; padding columns have t_max = 0 (never enter anything).

    Mirrors ops/intersect.py:ray_shear — kz = argmax |d|, shear maps the
    ray to +z."""
    from curry_pbrt_tpu.ops.intersect import ray_shear

    n = o.shape[0]
    kz, sx, sy, sz = ray_shear(d)
    inv_d = 1.0 / jnp.where(d == 0, Float(1e-30), d)
    rows = jnp.stack(
        [
            o[:, 0], o[:, 1], o[:, 2],
            sx, sy, sz,
            t_max,
            kz.astype(Float),
            inv_d[:, 0], inv_d[:, 1], inv_d[:, 2],
            # raw direction (the sphere tile test needs d itself; 1/(1/d)
            # does not round-trip bit-exactly)
            d[:, 0], d[:, 1], d[:, 2],
        ],
        axis=0,
    )
    n_pad = _round_up(max(n, 1), block_r)
    return jnp.pad(rows, ((0, 0), (0, n_pad - n)))


def block_aabbs(p0, p1, p2, valid, block_t: int = BLOCK_T) -> np.ndarray:
    """Host-side per-block_t cluster AABBs → (T_pad/block_t, 8) f32.

    Invalid/padding rows are excluded; an all-invalid block gets a NaN box."""
    p0 = np.asarray(p0, np.float32)
    p1 = np.asarray(p1, np.float32)
    p2 = np.asarray(p2, np.float32)
    valid = np.asarray(valid, bool)
    t = p0.shape[0]
    t_pad = _round_up(max(t, 1), block_t)
    nb = t_pad // block_t
    pad = t_pad - t
    if pad:
        z = np.full((pad, 3), np.nan, np.float32)
        p0, p1, p2 = (np.concatenate([a, z]) for a in (p0, p1, p2))
        valid = np.concatenate([valid, np.zeros((pad,), bool)])
    tmin = np.minimum(np.minimum(p0, p1), p2)
    tmax = np.maximum(np.maximum(p0, p1), p2)
    nanv = np.where(valid[:, None], 0.0, np.nan).astype(np.float32)
    out = np.zeros((nb, 8), np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN slices
        out[:, 0:3] = np.nanmin((tmin + nanv).reshape(nb, block_t, 3), axis=1)
        out[:, 3:6] = np.nanmax((tmax + nanv).reshape(nb, block_t, 3), axis=1)
    return out


def union_boxes(boxes: np.ndarray) -> np.ndarray:
    """(..., k, 8) NaN-aware AABB union → (..., 8); all-NaN → NaN box."""
    out = np.zeros(boxes.shape[:-2] + (8,), np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        out[..., 0:3] = np.nanmin(boxes[..., 0:3], axis=-2)
        out[..., 3:6] = np.nanmax(boxes[..., 3:6], axis=-2)
    return out


def kdmedian_order(p0, p1, p2, block_t: int) -> np.ndarray:
    """Host-side blocked kd-median permutation: recursively split the
    triangle set on the widest centroid axis at the nearest multiple of
    block_t to the median, so every contiguous block_t run is one kd cell.

    Cells are compact axis-aligned regions — tighter cluster AABBs than
    same-size Morton runs (a Z-curve block can straddle curve jumps). Exact
    block_t fills keep the tile math fully used. Deterministic (stable
    sorts)."""
    c = ((np.asarray(p0, np.float64) + np.asarray(p1) + np.asarray(p2)) / 3.0)
    n = c.shape[0]
    order = np.arange(n)
    stack = [(0, n)]
    while stack:
        lo, hi = stack.pop()
        count = hi - lo
        if count <= block_t:
            continue
        idx = order[lo:hi]
        ext = c[idx].max(axis=0) - c[idx].min(axis=0)
        axis = int(np.argmax(ext))
        order[lo:hi] = idx[np.argsort(c[idx, axis], kind="stable")]
        half = count // 2
        k = int(np.clip(round(half / block_t) * block_t, block_t,
                        ((count - 1) // block_t) * block_t))
        stack.append((lo, lo + k))
        stack.append((lo + k, hi))
    return order.astype(np.int32)


def morton_order(p0, p1, p2) -> np.ndarray:
    """Host-side Morton (Z-curve) permutation of triangle centroids (the
    baseline kdmedian_order is measured against)."""
    c = (np.asarray(p0, np.float64) + np.asarray(p1) + np.asarray(p2)) / 3.0
    lo, hi = c.min(axis=0), c.max(axis=0)
    ext = np.where(hi - lo > 0, hi - lo, 1.0)
    q = np.clip(((c - lo) / ext * 1023.0).astype(np.uint64), 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    key = (spread(q[:, 0]) << np.uint64(2)) | (spread(q[:, 1]) << np.uint64(1)) | spread(q[:, 2])
    return np.argsort(key, kind="stable").astype(np.int32)


@dataclasses.dataclass
class TriTables:
    """Host-built (numpy) kernel tables: kd-ordered, front-to-back
    super/cluster permuted, padded to whole slabs."""

    p0: np.ndarray  # (T_pad, 3) final kernel row order
    p1: np.ndarray
    p2: np.ndarray
    prim: np.ndarray  # (T_pad,) i32, -1 = padding
    valid: np.ndarray  # (T_pad,) bool
    tri_rows: np.ndarray  # (TRI_ROWS, T_pad) packed kernel layout
    cluster_aabbs: np.ndarray  # (C, 8)
    super_aabbs: np.ndarray  # (C // SUPER_G, 8)
    slab_aabbs: np.ndarray  # (n_slabs, 8)
    block_t: int
    clusters_per_slab: int
    use_supers: bool

    @property
    def n_slabs(self) -> int:
        return self.slab_aabbs.shape[0]


def pack_tris(p0, p1, p2, valid) -> np.ndarray:
    """(T,3)×3 + (T,) bool → (TRI_ROWS, T) f32 column-major table."""
    t = np.asarray(p0).shape[0]
    out = np.zeros((TRI_ROWS, t), np.float32)
    out[0:3] = np.asarray(p0, np.float32).T
    out[3:6] = np.asarray(p1, np.float32).T
    out[6:9] = np.asarray(p2, np.float32).T
    out[9] = np.where(np.asarray(valid, bool), 1.0, -1.0)
    return out


def hierarchy_shape(n_items: int, block: int, clusters_per_slab: int,
                    use_supers=None):
    """(n_clusters, clusters_per_slab, n_slabs, use_supers) for n_items
    primitives in clusters of `block`: supers and multi-slab layouts pad
    the cluster count to whole SUPER_G groups and whole slabs; a scene of
    one slab without supers keeps its exact cluster count."""
    nc_raw = -(-max(n_items, 1) // block)
    if use_supers is None:
        use_supers = nc_raw > USE_SUPERS_MIN
    use_supers = bool(use_supers)
    if use_supers or nc_raw > clusters_per_slab:
        nc = _round_up(nc_raw, SUPER_G)
        cps = int(min(clusters_per_slab, nc))
        if cps % SUPER_G:
            raise ValueError(f"clusters_per_slab must be a multiple of {SUPER_G}")
        n_slabs = -(-nc // cps)
        nc = n_slabs * cps
    else:
        nc, cps, n_slabs = nc_raw, nc_raw, 1
    return nc, cps, n_slabs, use_supers and cps > SUPER_G


def front_to_back(caabb: np.ndarray, view_origin) -> np.ndarray:
    """Cluster permutation: supers front-to-back from view_origin, then
    clusters within each super (padding clusters last)."""
    nc = caabb.shape[0]
    vo = np.asarray(view_origin, np.float64)
    ccent = (caabb[:, 0:3].astype(np.float64) + caabb[:, 3:6]) * 0.5
    cdist = np.linalg.norm(ccent - vo, axis=-1)
    cdist = np.where(np.isnan(cdist), np.inf, cdist)
    if nc % SUPER_G:
        return np.argsort(cdist, kind="stable")
    ns = nc // SUPER_G
    sdist = cdist.reshape(ns, SUPER_G).min(axis=1)
    sorder = np.argsort(sdist, kind="stable")
    within = np.argsort(cdist.reshape(ns, SUPER_G), axis=1, kind="stable")
    return (sorder[:, None] * SUPER_G + within[sorder]).reshape(-1)


def level_aabbs(caabb: np.ndarray, cps: int, n_slabs: int, use_supers: bool):
    """(super AABBs, slab AABBs) from cluster AABBs in final order. Without
    supers the super table is a (1, 8) placeholder the kernel never reads."""
    if use_supers:
        saabb = union_boxes(caabb.reshape(-1, SUPER_G, 8))
    else:
        saabb = union_boxes(caabb[None, :, :])
    return saabb, union_boxes(caabb.reshape(n_slabs, cps, 8))


def build_tri_tables(
    p0, p1, p2, prim,
    block_t: int = BLOCK_T,
    view_origin=None,
    clusters_per_slab: int = SLAB_CLUSTERS,
    use_supers=None,
) -> TriTables:
    """Spatially sort triangles into blocked kd cells, group block_t rows
    into clusters and SUPER_G clusters into supers, order supers (and
    clusters within supers) front-to-back from view_origin, pad to whole
    slabs, and precompute every AABB level + the packed table.
    Deterministic."""
    _check_pow2("block_t", block_t)
    p0 = np.asarray(p0, np.float32)
    p1 = np.asarray(p1, np.float32)
    p2 = np.asarray(p2, np.float32)
    prim = np.asarray(prim, np.int32)

    order = kdmedian_order(p0, p1, p2, block_t)
    p0, p1, p2, prim = p0[order], p1[order], p2[order], prim[order]

    t = p0.shape[0]
    nc, cps, n_slabs, use_supers = hierarchy_shape(
        t, block_t, clusters_per_slab, use_supers)
    t_pad = nc * block_t
    if t_pad > t:
        z = np.zeros((t_pad - t, 3), np.float32)
        p0, p1, p2 = (np.concatenate([a, z]) for a in (p0, p1, p2))
        prim = np.concatenate([prim, np.full((t_pad - t,), -1, np.int32)])
    valid = prim >= 0

    caabb = block_aabbs(p0, p1, p2, valid, block_t)
    if view_origin is not None:
        cluster_order = front_to_back(caabb, view_origin)
        row_order = (
            cluster_order[:, None] * block_t + np.arange(block_t)[None, :]
        ).reshape(-1)
        p0, p1, p2 = p0[row_order], p1[row_order], p2[row_order]
        prim, valid = prim[row_order], valid[row_order]
        caabb = caabb[cluster_order]
    saabb, slab_aabb = level_aabbs(caabb, cps, n_slabs, use_supers)

    return TriTables(
        p0=p0, p1=p1, p2=p2, prim=prim, valid=valid,
        tri_rows=pack_tris(p0, p1, p2, valid),
        cluster_aabbs=caabb, super_aabbs=saabb, slab_aabbs=slab_aabb,
        block_t=block_t, clusters_per_slab=cps, use_supers=use_supers,
    )


def _any(mask):
    """Scalar 'any lane set' (Triton has no boolean reduction)."""
    return jnp.max(mask.astype(jnp.int32)) > 0


def _box_enter(aabb_ref, row, ray, t_best):
    """Slab test of the program's rays vs AABB table row `row` → (block_r,)
    bool. Conservative (1+2γ₃) widening as in bounds.rs:303-323."""

    def slab(k):
        t0 = (aabb_ref[row, k] - ray[k]) * ray[8 + k]
        t1 = (aabb_ref[row, 3 + k] - ray[k]) * ray[8 + k]
        return jnp.minimum(t0, t1), jnp.maximum(t0, t1) * _T_SCALE

    nx, fx = slab(0)
    ny, fy = slab(1)
    nz, fz = slab(2)
    tn = jnp.maximum(nx, jnp.maximum(ny, nz))
    tf = jnp.minimum(fx, jnp.minimum(fy, fz))
    # `t_best > 0` is the dead-lane gate: integrators pass t_max=0 for lanes
    # whose result is discarded, but a stale origin sitting ON its last hit
    # is inside that cluster's AABB (tn < 0 < tf), so without this check the
    # lane still enters and triggers tile tests it can never win.
    return (tn <= tf) & (tn < t_best) & (tf > 0.0) & (t_best > 0.0)


def _tri_tile_test(ray, prims, t_best):
    """Watertight test of one (block_t, block_r) tile: prims are the
    cluster's TRI_ROWS columns as (block_t, 1), ray rows (1, block_r),
    t_best (1, block_r). Returns (t, ok): t is FLOAT_MAX where no hit."""
    ox, oy, oz = ray[0], ray[1], ray[2]
    sx, sy, sz = ray[3], ray[4], ray[5]
    kz = ray[7]

    def permuted(px, py, pz):
        """Translate by -o, then (v[kx], v[ky], v[kz]) with kx=(kz+1)%3,
        ky=(kz+2)%3 — ops/intersect.py:permute_by_kz."""
        tx = px - ox
        ty = py - oy
        tz = pz - oz
        qx = jnp.where(kz == 0.0, ty, jnp.where(kz == 1.0, tz, tx))
        qy = jnp.where(kz == 0.0, tz, jnp.where(kz == 1.0, tx, ty))
        qz = jnp.where(kz == 0.0, tx, jnp.where(kz == 1.0, ty, tz))
        return qx, qy, qz

    q0x, q0y, q0z = permuted(prims[0], prims[1], prims[2])
    q1x, q1y, q1z = permuted(prims[3], prims[4], prims[5])
    q2x, q2y, q2z = permuted(prims[6], prims[7], prims[8])
    valid = prims[9] > 0.0

    x0 = q0x + sx * q0z; y0 = q0y + sy * q0z
    x1 = q1x + sx * q1z; y1 = q1y + sy * q1z
    x2 = q2x + sx * q2z; y2 = q2y + sy * q2z

    e0 = x1 * y2 - y1 * x2
    e1 = x2 * y0 - y2 * x0
    e2 = x0 * y1 - y0 * x1
    same_side = ~(((e0 < 0) | (e1 < 0) | (e2 < 0)) & ((e0 > 0) | (e1 > 0) | (e2 > 0)))
    det = e0 + e1 + e2
    z0 = q0z * sz; z1 = q1z * sz; z2 = q2z * sz
    t_scaled = e0 * z0 + e1 * z1 + e2 * z2
    neg_det = det < 0
    in_range = (neg_det & (t_scaled < 0) & (t_scaled >= t_best * det)) | (
        ~neg_det & (t_scaled > 0) & (t_scaled <= t_best * det)
    )
    safe_det = jnp.where(det == 0, 1.0, det)
    inv_det = 1.0 / safe_det
    t = t_scaled * inv_det

    # conservative fp-error rejection (triangle.rs:243-257)
    max_zt = jnp.maximum(jnp.abs(z0), jnp.maximum(jnp.abs(z1), jnp.abs(z2)))
    max_xt = jnp.maximum(jnp.abs(x0), jnp.maximum(jnp.abs(x1), jnp.abs(x2)))
    max_yt = jnp.maximum(jnp.abs(y0), jnp.maximum(jnp.abs(y1), jnp.abs(y2)))
    delta_z = _G3 * max_zt
    delta_x = _G5 * (max_xt + max_zt)
    delta_y = _G5 * (max_yt + max_zt)
    delta_e = 2.0 * (_G2 * max_xt * max_yt + delta_y * max_xt + delta_x * max_yt)
    max_e = jnp.maximum(jnp.abs(e0), jnp.maximum(jnp.abs(e1), jnp.abs(e2)))
    delta_t = (
        3.0
        * (_G3 * max_e * max_zt + delta_e * max_zt + delta_z * max_e)
        * jnp.abs(inv_det)
    )

    ok = valid & same_side & (det != 0) & in_range & (t > delta_t)
    return jnp.where(ok, t, FLOAT_MAX), ok


@dataclasses.dataclass(frozen=True)
class Traversal:
    """Static shape of one cluster traversal kernel."""

    tile_test: object  # (ray rows, prim columns, t_best) -> (t, ok)
    n_rows: int  # rows of the primitive table
    block_t: int  # primitives per cluster
    clusters_per_slab: int
    n_slabs: int
    use_supers: bool
    block_r: int = BLOCK_R
    num_warps: int = NUM_WARPS
    num_stages: int = NUM_STAGES


def _make_kernel(tr: Traversal, any_hit: bool, stats: bool):
    """Kernel over one ray block: slabs → supers → clusters, each level a
    loop inside the program gated by its AABB test; a cluster's tile math
    runs only when some ray of the block enters it. Any-hit loops stop once
    every ray of the block has hit.

    With stats=True (closest-hit only) two more outputs count, per ray,
    the cluster tiles its block executed (entered) and those that improved
    some ray's best t (improved)."""
    bt, br, cps = tr.block_t, tr.block_r, tr.clusters_per_slab
    n_super = cps // SUPER_G

    def kernel(slab_ref, super_ref, caabb_ref, rays_ref, prims_ref, *out_refs):
        rs = pl.ds(pl.multiple_of(pl.program_id(0) * br, br), br)
        ray = [rays_ref[k, rs] for k in range(RAY_ROWS)]
        t_max = ray[6]
        ray2 = [r[None, :] for r in ray]

        def live(carry):
            """Rays still looking: the any-hit flags not yet set."""
            return carry[0] == 0

        def enters(aabb_ref, row, carry):
            if any_hit:
                return _box_enter(aabb_ref, row, ray, t_max) & live(carry)
            return _box_enter(aabb_ref, row, ray, carry[0])

        def loop(n, body, carry):
            if not any_hit:
                return jax.lax.fori_loop(0, n, body, carry)

            def cond(state):
                return (state[0] < n) & _any(live(state[1]))

            def step(state):
                return state[0] + 1, body(state[0], state[1])

            return jax.lax.while_loop(cond, step, (jnp.int32(0), carry))[1]

        def tile(c, carry):
            off = pl.multiple_of(c * bt, bt)
            prims = [prims_ref[k, pl.ds(off, bt)][:, None] for k in range(tr.n_rows)]
            if any_hit:
                _t, ok = tr.tile_test(ray2, prims, t_max[None, :])
                return (jnp.maximum(carry[0], jnp.max(ok.astype(jnp.int32), axis=0)),)
            t_best, idx = carry[0], carry[1]
            t, _ok = tr.tile_test(ray2, prims, t_best[None, :])
            t_min = jnp.min(t, axis=0)
            row = jnp.argmin(t, axis=0).astype(jnp.int32)
            # strict improvement, EXCEPT the first hit may land exactly at
            # the incoming t_max (the brute path's watertight in_range
            # accepts t <= t_max). The FLOAT_MAX guard keeps no-hit tiles
            # from writing a phantom index.
            better = (t_min < t_best) | (
                (t_min == t_best) & (idx < 0) & (t_min < FLOAT_MAX)
            )
            out = (jnp.where(better, t_min, t_best),
                   jnp.where(better, c * bt + row, idx))
            if stats:
                out += (carry[2] + 1,
                        carry[3] + _any(better).astype(jnp.int32))
            return out

        def cluster(c, carry):
            return jax.lax.cond(_any(enters(caabb_ref, c, carry)), tile,
                                lambda _c, cr: cr, c, carry)

        def supers_of(j, carry):
            def super_body(s, carry):
                srow = j * n_super + s

                def children(carry):
                    return jax.lax.fori_loop(
                        0, SUPER_G,
                        lambda k, cr: cluster(srow * SUPER_G + k, cr), carry)

                return jax.lax.cond(_any(enters(super_ref, srow, carry)),
                                    children, lambda cr: cr, carry)

            return loop(n_super, super_body, carry)

        def clusters_of(j, carry):
            return loop(cps, lambda c, cr: cluster(j * cps + c, cr), carry)

        sweep = supers_of if tr.use_supers else clusters_of

        def slab(j, carry):
            return jax.lax.cond(_any(enters(slab_ref, j, carry)), sweep,
                                lambda _j, cr: cr, j, carry)

        if any_hit:
            carry = (jnp.zeros((br,), jnp.int32),)
        else:
            carry = (t_max, jnp.full((br,), -1, jnp.int32))
            if stats:
                carry += (jnp.zeros((br,), jnp.int32),) * 2
        if tr.n_slabs > 1:
            carry = loop(tr.n_slabs, slab, carry)
        else:  # one slab: its AABB test can never skip anything
            carry = sweep(0, carry)
        for ref, val in zip(out_refs, carry):
            ref[rs] = val

    return kernel


def run_traversal(tr: Traversal, o, d, t_max, prim_rows, caabb, saabb,
                  slab_aabb, *, any_hit: bool, stats: bool = False,
                  interpret: bool = False):
    """Pack rays, launch the cluster traversal over ray blocks, unpad.

    → any_hit: (N,) bool; else (t (N,) FLOAT_MAX on miss, idx (N,) i32
    table column or -1) and, with stats, per-ray (entered, improved)
    cluster-tile counts."""
    _check_pow2("block_r", tr.block_r)
    _check_pow2("block_t", tr.block_t)
    if prim_rows.shape != (tr.n_rows, caabb.shape[0] * tr.block_t):
        raise ValueError(
            f"primitive table {prim_rows.shape} does not hold "
            f"{caabb.shape[0]} clusters of {tr.block_t}")
    if caabb.shape[0] != tr.n_slabs * tr.clusters_per_slab:
        raise ValueError("cluster table is not a whole number of slabs")
    n = o.shape[0]
    rays = pack_rays(o, d, t_max, tr.block_r)
    n_pad = rays.shape[1]
    if any_hit:
        out_shape = [jax.ShapeDtypeStruct((n_pad,), jnp.int32)]
    else:
        out_shape = [jax.ShapeDtypeStruct((n_pad,), Float),
                     jax.ShapeDtypeStruct((n_pad,), jnp.int32)]
        if stats:
            out_shape += [jax.ShapeDtypeStruct((n_pad,), jnp.int32)] * 2
    outs = pl.pallas_call(
        _make_kernel(tr, any_hit, stats),
        grid=(n_pad // tr.block_r,),
        out_shape=out_shape,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=tr.num_warps,
                                                 num_stages=tr.num_stages),
        interpret=interpret,
        name="cluster_any_hit" if any_hit else "cluster_closest_hit",
    )(slab_aabb, saabb, caabb, rays, prim_rows)
    if any_hit:
        return outs[0][:n] > 0
    t, idx = outs[0][:n], outs[1][:n]
    result = (jnp.where(idx >= 0, t, FLOAT_MAX), idx)
    if stats:
        return result + (outs[2][:n], outs[3][:n])
    return result


_TABLE_STATICS = ("interpret", "block_t", "block_r", "clusters_per_slab",
                  "use_supers")


def _tri_traversal(slab_aabb, block_t, clusters_per_slab, use_supers, block_r):
    return Traversal(_tri_tile_test, TRI_ROWS, block_t, clusters_per_slab,
                     slab_aabb.shape[0], use_supers, block_r)


@functools.partial(jax.jit, static_argnames=_TABLE_STATICS + ("stats",))
def tri_closest_hit_tables(o, d, t_max, tri_rows, caabb, saabb, slab_aabb, *,
                           block_t: int, clusters_per_slab: int,
                           use_supers: bool, interpret=False,
                           block_r: int = BLOCK_R, stats: bool = False):
    """Closest-hit over prebuilt TriTables arrays. o/d: (N,3), t_max: (N,).
    Returns (t: (N,), tri: (N,) i32 table column, -1 on miss); with
    stats=True also per-ray (entered, improved) cluster-tile counts: every
    ray of a block carries its block's counts, so sum(entered)·block_t is
    the number of (triangle, ray) pair tests executed."""
    tr = _tri_traversal(slab_aabb, block_t, clusters_per_slab, use_supers,
                        block_r)
    return run_traversal(tr, o, d, t_max, tri_rows, caabb, saabb, slab_aabb,
                         any_hit=False, stats=stats, interpret=interpret)


@functools.partial(jax.jit, static_argnames=_TABLE_STATICS)
def tri_any_hit_tables(o, d, t_max, tri_rows, caabb, saabb, slab_aabb, *,
                       block_t: int, clusters_per_slab: int,
                       use_supers: bool, interpret=False,
                       block_r: int = BLOCK_R):
    """Any-hit (shadow) test over prebuilt TriTables arrays → (N,) bool."""
    tr = _tri_traversal(slab_aabb, block_t, clusters_per_slab, use_supers,
                        block_r)
    return run_traversal(tr, o, d, t_max, tri_rows, caabb, saabb, slab_aabb,
                         any_hit=True, interpret=interpret)


def _tables_from_aabbs(p0, p1, p2, valid, aabbs, block_t):
    """Single-slab tables around caller-built cluster AABBs (no
    reordering). Host-side only — call with concrete arrays."""
    aabbs = np.asarray(aabbs, np.float32)
    nc = aabbs.shape[0]
    rows = np.zeros((TRI_ROWS, nc * block_t), np.float32)
    rows[9] = -1.0
    t = np.asarray(p0).shape[0]
    rows[:, :t] = pack_tris(p0, p1, p2, valid)
    slab_aabb = union_boxes(aabbs[None, :, :])
    return (jnp.asarray(rows), jnp.asarray(aabbs), jnp.asarray(slab_aabb),
            jnp.asarray(slab_aabb), nc)


def tri_closest_hit_pallas(o, d, t_max, p0, p1, p2, valid, aabbs, *,
                           interpret=False, block_t=BLOCK_T, block_r=BLOCK_R):
    """Closest-hit over a triangle soup with caller-built cluster AABBs
    (single-slab form of tri_closest_hit_tables). Returns (t: (N,),
    tri: (N,) i32 row index, -1 on miss)."""
    rows, caabb, saabb, slab_aabb, cps = _tables_from_aabbs(
        p0, p1, p2, valid, aabbs, block_t
    )
    return tri_closest_hit_tables(
        o, d, t_max, rows, caabb, saabb, slab_aabb,
        block_t=block_t, clusters_per_slab=cps, use_supers=False,
        interpret=interpret, block_r=block_r,
    )


def tri_any_hit_pallas(o, d, t_max, p0, p1, p2, valid, aabbs, *,
                       interpret=False, block_t=BLOCK_T, block_r=BLOCK_R):
    """Any-hit (shadow) test (single-slab form). Returns (N,) bool."""
    rows, caabb, saabb, slab_aabb, cps = _tables_from_aabbs(
        p0, p1, p2, valid, aabbs, block_t
    )
    return tri_any_hit_tables(
        o, d, t_max, rows, caabb, saabb, slab_aabb,
        block_t=block_t, clusters_per_slab=cps, use_supers=False,
        interpret=interpret, block_r=block_r,
    )
