"""Sphere cluster kernel: cluster-culled closest/any-hit over sphere
tables, replacing the dense O(rays × spheres) jnp path beyond a few
clusters' worth of spheres (the reference puts spheres in its BVH like any
primitive, aggregate/bvh.rs:24-124).

Reuses the triangle kernel's traversal wholesale (same ray packing, same
(1+2γ₃)-widened slab tests, same slab/super/cluster sweep —
intersect_kernel.run_traversal is parameterized by tile test): only the
per-pair math differs. A sphere is one table column holding its
world-to-object transform + radius; the tile test maps each ray into each
sphere's object space ((S,1) × (1,R) tiles) and solves the reference's
stable q-form quadratic (sphere.rs:111-132) — the same operations as
ops/intersect.sphere_quadratic.

Sphere table layout (SPH_ROWS, S_pad) f32, column-major:
  rows 0-8  w2o rotation (r00 r01 r02 r10 .. r22)
  rows 9-11 w2o translation
  row 12    radius
  row 13    valid flag (+1/-1)
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from curry_pbrt_tpu.dtypes import FLOAT_MAX
from curry_pbrt_tpu.ops.pallas.intersect_kernel import (
    BLOCK_R,
    SLAB_CLUSTERS,
    Traversal,
    _check_pow2,
    front_to_back,
    hierarchy_shape,
    kdmedian_order,
    level_aabbs,
    run_traversal,
    union_boxes,
)

BLOCK_S = 32  # spheres per cluster
SPH_ROWS = 14


def _sphere_tile_test(ray, sph, t_best):
    """Stable-quadratic test of one (block_s, block_r) tile. Returns (t, ok)
    with FLOAT_MAX misses — same acceptance as sphere_quadratic: t0 if ≥ 0
    else t1, reject t0 > t_best or t1 < 0."""
    ox, oy, oz = ray[0], ray[1], ray[2]
    dx, dy, dz = ray[11], ray[12], ray[13]
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = sph[0:9]
    tx, ty, tz = sph[9], sph[10], sph[11]
    radius = sph[12]
    valid = sph[13] > 0.0

    oox = m00 * ox + m01 * oy + m02 * oz + tx  # (S, R)
    ooy = m10 * ox + m11 * oy + m12 * oz + ty
    ooz = m20 * ox + m21 * oy + m22 * oz + tz
    ddx = m00 * dx + m01 * dy + m02 * dz
    ddy = m10 * dx + m11 * dy + m12 * dz
    ddz = m20 * dx + m21 * dy + m22 * dz

    a = ddx * ddx + ddy * ddy + ddz * ddz
    safe_a = jnp.where(a == 0, 1.0, a)
    b_half = oox * ddx + ooy * ddy + ooz * ddz
    r2 = radius * radius
    c = oox * oox + ooy * ooy + ooz * ooz - r2
    t_center = -b_half / safe_a
    px = oox + t_center * ddx
    py = ooy + t_center * ddy
    pz = ooz + t_center * ddz
    perp2 = px * px + py * py + pz * pz
    disc_ok = (perp2 <= r2) & (a > 0)
    # safe_sqrt's forward form (double-where), the dense path's operations
    disc = a * (r2 - perp2)
    s = jnp.where(disc <= 0.0, 0.0,
                  jnp.sqrt(jnp.where(disc <= 0.0, 1.0, disc)))
    sgn = jnp.where(b_half >= 0, 1.0, -1.0)
    q = -(b_half + sgn * s)
    safe_q = jnp.where(q == 0, 1.0, q)
    r1 = q / safe_a
    r2_ = jnp.where(q == 0, r1, c / safe_q)
    t0 = jnp.minimum(r1, r2_)
    t1 = jnp.maximum(r1, r2_)
    t = jnp.where(t0 >= 0.0, t0, t1)
    ok = valid & disc_ok & (t0 <= t_best) & (t1 >= 0.0) & (t <= t_best)
    return jnp.where(ok, t, FLOAT_MAX), ok


@dataclasses.dataclass
class SphereTables:
    """Host-built sphere kernel tables (kd-ordered, slab-padded)."""

    sph_rows: np.ndarray  # (SPH_ROWS, S_pad)
    row_sphere: np.ndarray  # (S_pad,) i32 original sphere index, -1 pad
    cluster_aabbs: np.ndarray  # (C, 8)
    super_aabbs: np.ndarray
    slab_aabbs: np.ndarray
    block_s: int
    clusters_per_slab: int
    use_supers: bool


def build_sphere_tables(
    w2o, o2w, radius, prim,
    block_s: int = BLOCK_S,
    view_origin=None,
    clusters_per_slab: int = SLAB_CLUSTERS,
    use_supers=None,
) -> SphereTables:
    """kd-median-order spheres by world center, group block_s columns into
    AABB-carrying clusters (+supers/slabs as the tri tables), order
    front-to-back from view_origin. Invalid columns get valid=-1."""
    _check_pow2("block_s", block_s)
    w2o = np.asarray(w2o, np.float32)
    o2w = np.asarray(o2w, np.float32)
    radius = np.asarray(radius, np.float32)
    prim = np.asarray(prim, np.int32)
    s = radius.shape[0]

    centers = o2w[:, :3, 3]
    # conservative world radius of the transformed object-space sphere
    # (same bound as ops/bvh._prim_bounds)
    rw = np.abs(o2w[:, :3, :3]).sum(axis=2).max(axis=1) * radius

    order = kdmedian_order(centers, centers, centers, block_s)
    w2o, radius, prim = w2o[order], radius[order], prim[order]
    centers, rw = centers[order], rw[order]

    nc, cps, n_slabs, use_supers = hierarchy_shape(
        s, block_s, clusters_per_slab, use_supers)
    s_pad = nc * block_s

    sph = np.zeros((SPH_ROWS, s_pad), np.float32)
    sph[13] = -1.0
    sph[0:9, :s] = w2o[:, :3, :3].reshape(s, 9).T
    sph[9:12, :s] = w2o[:, :3, 3].T
    sph[12, :s] = radius
    sph[13, :s] = np.where(prim >= 0, 1.0, -1.0)
    row_sphere = np.concatenate(
        [order.astype(np.int32), np.full((s_pad - s,), -1, np.int32)]
    )

    valid = sph[13] > 0
    bmin = np.where(valid[:s, None], centers - rw[:, None], np.nan)
    bmax = np.where(valid[:s, None], centers + rw[:, None], np.nan)
    bmin = np.concatenate([bmin, np.full((s_pad - s, 3), np.nan, np.float32)])
    bmax = np.concatenate([bmax, np.full((s_pad - s, 3), np.nan, np.float32)])
    boxes8 = np.concatenate(
        [bmin, bmax, np.zeros((s_pad, 2), np.float32)], axis=-1
    ).astype(np.float32)
    caabb = union_boxes(boxes8.reshape(nc, block_s, 8))

    if view_origin is not None:
        cluster_order = front_to_back(caabb, view_origin)
        col_order = (
            cluster_order[:, None] * block_s + np.arange(block_s)[None, :]
        ).reshape(-1)
        sph, row_sphere = sph[:, col_order], row_sphere[col_order]
        caabb = caabb[cluster_order]
    saabb, slab_aabb = level_aabbs(caabb, cps, n_slabs, use_supers)

    return SphereTables(
        sph_rows=sph, row_sphere=row_sphere, cluster_aabbs=caabb,
        super_aabbs=saabb, slab_aabbs=slab_aabb, block_s=block_s,
        clusters_per_slab=cps, use_supers=use_supers,
    )


_STATICS = ("interpret", "block_s", "block_r", "clusters_per_slab",
            "use_supers")


def _sphere_traversal(slab_aabb, block_s, clusters_per_slab, use_supers,
                      block_r):
    return Traversal(_sphere_tile_test, SPH_ROWS, block_s, clusters_per_slab,
                     slab_aabb.shape[0], use_supers, block_r)


@functools.partial(jax.jit, static_argnames=_STATICS)
def sphere_closest_hit_tables(o, d, t_max, sph_rows, caabb, saabb, slab_aabb,
                              *, block_s: int, clusters_per_slab: int,
                              use_supers: bool, interpret=False,
                              block_r: int = BLOCK_R):
    """Closest-hit over sphere tables → (t: (N,), col: (N,) i32 table
    column, -1 on miss)."""
    tr = _sphere_traversal(slab_aabb, block_s, clusters_per_slab, use_supers,
                           block_r)
    return run_traversal(tr, o, d, t_max, sph_rows, caabb, saabb, slab_aabb,
                         any_hit=False, interpret=interpret)


@functools.partial(jax.jit, static_argnames=_STATICS)
def sphere_any_hit_tables(o, d, t_max, sph_rows, caabb, saabb, slab_aabb, *,
                          block_s: int, clusters_per_slab: int,
                          use_supers: bool, interpret=False,
                          block_r: int = BLOCK_R):
    """Any-hit over sphere tables → (N,) bool."""
    tr = _sphere_traversal(slab_aabb, block_s, clusters_per_slab, use_supers,
                           block_r)
    return run_traversal(tr, o, d, t_max, sph_rows, caabb, saabb, slab_aabb,
                         any_hit=True, interpret=interpret)
