"""Pallas-backed aggregate: hierarchical cluster-culled closest/any-hit.

Drop-in replacement for the jnp brute intersector (ops/intersect.py) that
scales from a Cornell box to 600k+ triangle scenes: triangles are sorted
host-side into AABB-carrying kd clusters, clusters into super-clusters and
slabs (see ops/pallas/intersect_kernel.py for the in-kernel three-level
cull). Memory traffic is O(N + T·n_ray_blocks): the jnp dense path
materialises (rays × prims) intermediates instead.

Spheres run through the jnp dense test below SPH_KERNEL_MIN (reference
scenes have ≤3) and through their own cluster-culled kernel
(sphere_kernel.py, the same traversal) beyond it. Hit attributes are
reconstructed only for each ray's winning primitive.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from curry_pbrt_tpu.dtypes import FLOAT_MAX, Float
from curry_pbrt_tpu.ops import intersect as isect
from curry_pbrt_tpu.ops.pallas import intersect_kernel as ik

SMALL_SCENE_TRIS = 512  # at most this many triangles: small clusters
SMALL_BLOCK_T = 8
SPH_KERNEL_MIN = 129  # spheres: the cluster kernel from this count on


def plan_tri_kernel(tris: isect.TriangleArrays, view_origin=None):
    """Scene-adaptive host tables for the triangle kernel."""
    # small scenes get 8-tri clusters so their handful of surfaces cull
    # each other (a Cornell box inside one big cluster = zero culling)
    small = tris.count <= SMALL_SCENE_TRIS
    block_t = SMALL_BLOCK_T if small else ik.BLOCK_T
    # kd sort + super-cluster grouping + front-to-back ordering + slab
    # padding, all host-side (see build_tri_tables). Kernel-side indices
    # are table-column order; the permuted TriangleArrays carries prim ids
    # so Hit.prim needs no inverse mapping.
    tables = ik.build_tri_tables(
        tris.p0, tris.p1, tris.p2, tris.prim,
        block_t=block_t, view_origin=view_origin,
    )
    return tables


def make_pallas_intersectors(tris: isect.TriangleArrays, sph: isect.SphereArrays,
                             view_origin=None):
    """Returns (intersect, predicate, intersect_tprim) callables matching
    the brute API.

    view_origin (optional world-space camera position): clusters are swept
    front-to-back from it, so early hits tighten per-ray t and cull the
    clusters behind them — the cluster-level analog of the reference BVH's
    near-child-first traversal (bvh.rs:174-178). Scene-static, free at
    build; primary and shadow rays benefit most."""
    # "have" means VALID rows, not table rows: scenes keep 1 padding row in
    # empty tables (compiler), and an all-invalid table has no work to do
    have_tris = bool((np.asarray(tris.prim) >= 0).any())
    have_sph = bool((np.asarray(sph.prim) >= 0).any())
    n_sph = int((np.asarray(sph.prim) >= 0).sum())
    # beyond a few clusters' worth, spheres go through their own
    # cluster-culled kernel instead of the dense O(rays × spheres) jnp
    # test — the reference scales by putting spheres in its BVH like any
    # primitive (aggregate/bvh.rs:24-124)
    use_sph_kernel = n_sph >= SPH_KERNEL_MIN
    interp = ik.interpret_mode()

    if have_sph and use_sph_kernel:
        from curry_pbrt_tpu.ops.pallas.sphere_kernel import (
            build_sphere_tables,
            sphere_any_hit_tables,
            sphere_closest_hit_tables,
        )

        stab = build_sphere_tables(
            sph.w2o, sph.o2w, sph.radius, sph.prim, view_origin=view_origin
        )
        s_args = tuple(jnp.asarray(a) for a in (
            stab.sph_rows, stab.cluster_aabbs, stab.super_aabbs,
            stab.slab_aabbs))
        s_rows = jnp.asarray(stab.row_sphere)
        s_kw = dict(
            block_s=stab.block_s, clusters_per_slab=stab.clusters_per_slab,
            use_supers=stab.use_supers, interpret=interp,
        )

    def _sph_closest(o, d, t_max):
        """→ (t (N,), best original-sphere index (N,), hit (N,) bool) —
        dense argmin semantics (lowest index wins exact-t ties on the
        dense path; the kernel path's tie winner follows table order)."""
        if use_sph_kernel:
            t, col = sphere_closest_hit_tables(o, d, t_max, *s_args, **s_kw)
            best = jnp.take(s_rows, jnp.clip(col, 0, s_rows.shape[0] - 1))
            return t, jnp.maximum(best, 0), col >= 0
        st, sok = isect.sphere_intersect_t(o, d, t_max, sph)
        best = jnp.argmin(st, axis=-1).astype(jnp.int32)
        oh = jnp.arange(st.shape[1], dtype=jnp.int32)[None, :] == best[:, None]
        return jnp.min(st, axis=-1), best, jnp.any(sok & oh, axis=-1)

    def _sph_any(o, d, t_max):
        if use_sph_kernel:
            return sphere_any_hit_tables(o, d, t_max, *s_args, **s_kw)
        _st, sok = isect.sphere_intersect_t(o, d, t_max, sph)
        return jnp.any(sok, axis=-1)

    if have_tris:
        tables = plan_tri_kernel(tris, view_origin)
        tris = isect.TriangleArrays(
            jnp.asarray(tables.p0), jnp.asarray(tables.p1),
            jnp.asarray(tables.p2), jnp.asarray(tables.prim),
        )
        t_args = tuple(jnp.asarray(a) for a in (
            tables.tri_rows, tables.cluster_aabbs, tables.super_aabbs,
            tables.slab_aabbs))
        kern_kw = dict(
            block_t=tables.block_t, clusters_per_slab=tables.clusters_per_slab,
            use_supers=tables.use_supers, interpret=interp,
        )

    def _tri_closest(o, d, t_max):
        t, idx = ik.tri_closest_hit_tables(o, d, t_max, *t_args, **kern_kw)
        return t, idx, idx >= 0

    def intersect(o, d, t_max) -> isect.Hit:
        N = o.shape[0]
        p = jnp.zeros((N, 3), Float)
        n = jnp.zeros((N, 3), Float)
        uv = jnp.zeros((N, 2), Float)
        perr = jnp.zeros((N, 3), Float)
        prim = jnp.full((N,), -1, jnp.int32)
        t_out = jnp.broadcast_to(jnp.asarray(FLOAT_MAX), (N,))

        if have_tris:
            tri_t, tri_idx, tri_hit = _tri_closest(o, d, t_max)
        if have_sph:
            sph_t, sph_best, sph_hit = _sph_closest(o, d, t_max)

        if have_tris and have_sph:
            use_tri = tri_hit & (~sph_hit | (tri_t <= sph_t))
            use_sph = sph_hit & ~use_tri
        elif have_tris:
            use_tri, use_sph = tri_hit, None
        elif have_sph:
            use_tri, use_sph = None, sph_hit
        else:
            return isect.Hit(t_out, prim, p, n, uv, perr)

        if have_tris:
            safe_idx = jnp.clip(tri_idx, 0, tris.count - 1)
            # winner-only re-test + attributes, single vertex gather (O(N))
            tp, tn, tuv, terr = isect.triangle_winner_attributes(
                o, d, t_max, safe_idx, tris
            )
            m = use_tri[:, None]
            p = jnp.where(m, tp, p)
            n = jnp.where(m, tn, n)
            uv = jnp.where(use_tri[:, None], tuv, uv)
            perr = jnp.where(m, terr, perr)
            t_out = jnp.where(use_tri, tri_t, t_out)
            prim = jnp.where(use_tri, jnp.take(tris.prim, safe_idx), prim)
        if have_sph:
            sp, sn, suv, serr = isect.sphere_hit_attributes(sph_best, sph_t, o, d, sph)
            m = use_sph[:, None]
            p = jnp.where(m, sp, p)
            n = jnp.where(m, sn, n)
            uv = jnp.where(use_sph[:, None], suv, uv)
            perr = jnp.where(m, serr, perr)
            t_out = jnp.where(use_sph, sph_t, t_out)
            prim = jnp.where(use_sph, jnp.take(sph.prim, sph_best), prim)

        return isect.Hit(t_out, prim, p, n, uv, perr)

    def predicate(o, d, t_max):
        hit = jnp.zeros(o.shape[:1], bool)
        if have_tris:
            hit = hit | ik.tri_any_hit_tables(o, d, t_max, *t_args, **kern_kw)
        if have_sph:
            hit = hit | _sph_any(o, d, t_max)
        return hit

    def intersect_tprim(o, d, t_max):
        """(t, prim) only — skips the winner-bary + attribute pass."""
        N = o.shape[0]
        t_out = jnp.broadcast_to(jnp.asarray(FLOAT_MAX), (N,))
        prim = jnp.full((N,), -1, jnp.int32)
        if have_tris:
            tri_t, tri_idx, tri_hit = _tri_closest(o, d, t_max)
            safe_idx = jnp.clip(tri_idx, 0, tris.count - 1)
            t_out = jnp.where(tri_hit, tri_t, t_out)
            prim = jnp.where(tri_hit, jnp.take(tris.prim, safe_idx), prim)
        if have_sph:
            sph_t, sph_best, sph_hit = _sph_closest(o, d, t_max)
            use = sph_hit & (sph_t < t_out)
            t_out = jnp.where(use, sph_t, t_out)
            prim = jnp.where(use, jnp.take(sph.prim, sph_best), prim)
        return t_out, prim

    def _detached(fn):
        """Geometry gradients are detached through the kernel (pallas_call
        has no AD rule, and the differentiable-rendering design detaches
        visibility/sample positions — DESIGN.md; BASELINE north star
        promises parameter, not geometry-edge, gradients)."""

        def wrapped(o, d, t_max):
            return fn(
                jax.lax.stop_gradient(o),
                jax.lax.stop_gradient(d),
                jax.lax.stop_gradient(t_max),
            )

        return wrapped

    return _detached(intersect), _detached(predicate), _detached(intersect_tprim)
