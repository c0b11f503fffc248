"""Equivalence: Pallas cluster-culled triangle kernel vs the jnp brute
intersector.

Runs the Triton kernel in interpret mode on the CPU test platform (same math as
ops/intersect.py:watertight_core, so t values must match exactly and the
winning triangle must agree wherever the min is unique). The cluster AABB
cull must never change results — only skip work.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from curry_pbrt_tpu.ops import intersect as isect
from curry_pbrt_tpu.ops.pallas.intersect_kernel import (
    block_aabbs,
    morton_order,
    tri_any_hit_pallas,
    tri_closest_hit_pallas,
)


def _random_scene(seed, n_rays=64, n_tris=37, spread=2.0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, (n_tris, 3)).astype(np.float32)
    p0 = base
    p1 = base + rng.normal(0, 0.7, (n_tris, 3)).astype(np.float32)
    p2 = base + rng.normal(0, 0.7, (n_tris, 3)).astype(np.float32)
    o = rng.uniform(-4, 4, (n_rays, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full((n_rays,), 100.0, np.float32)
    return map(jnp.asarray, (o, d, t_max, p0, p1, p2))


def _aabbs(p0, p1, p2, valid=None):
    if valid is None:
        valid = jnp.ones((p0.shape[0],), bool)
    return jnp.asarray(block_aabbs(p0, p1, p2, valid)), valid


@pytest.mark.parametrize("seed,n_tris", [(0, 37), (1, 37), (2, 37), (4, 300)])
def test_closest_hit_matches_brute(seed, n_tris):
    # n_tris=300 spans 3 tri blocks → exercises the cluster cull + the
    # cross-block t tightening
    o, d, t_max, p0, p1, p2 = _random_scene(seed, n_tris=n_tris)
    tris = isect.TriangleArrays(p0, p1, p2, jnp.arange(p0.shape[0], dtype=jnp.int32))

    tt, _b, ok = isect.triangle_intersect_t(o, d, t_max, tris)
    ref_t = np.asarray(jnp.min(tt, axis=-1))
    ref_any = np.asarray(jnp.any(ok, axis=-1))

    aabbs, valid = _aabbs(p0, p1, p2)
    t, idx = tri_closest_hit_pallas(
        o, d, t_max, p0, p1, p2, valid, aabbs, interpret=True
    )
    t, idx = np.asarray(t), np.asarray(idx)

    assert np.array_equal(idx >= 0, ref_any)
    # same math, but XLA may fuse FMAs differently between the two lowerings:
    # allow last-ULP drift
    np.testing.assert_allclose(t[ref_any], ref_t[ref_any], rtol=1e-6, atol=0)
    # winning triangle must actually produce (essentially) the winning t
    tt = np.asarray(tt)
    for i in np.nonzero(ref_any)[0]:
        np.testing.assert_allclose(tt[i, idx[i]], ref_t[i], rtol=1e-6, atol=0)


def test_morton_order_is_permutation():
    _o, _d, _t, p0, p1, p2 = _random_scene(11, n_tris=500, spread=5.0)
    order = morton_order(p0, p1, p2)
    assert sorted(order.tolist()) == list(range(500))


def test_kdmedian_order_properties():
    """kdmedian_order: a deterministic permutation whose contiguous block_t
    runs are kd cells, and whose cluster AABBs are (in aggregate) tighter
    than Morton runs on a structured mesh (the reason it is the default)."""
    from curry_pbrt_tpu.ops.pallas.intersect_kernel import (
        block_aabbs,
        kdmedian_order,
    )

    for n in (500, 512, 65):  # non-multiple, exact, barely-splittable
        _o, _d, _t, p0, p1, p2 = _random_scene(11, n_tris=n, spread=5.0)
        order = kdmedian_order(p0, p1, p2, 64)
        assert sorted(order.tolist()) == list(range(n))
        order2 = kdmedian_order(p0, p1, p2, 64)
        np.testing.assert_array_equal(order, order2)

    # structured grid: kd cells must beat Z-curve runs on total cluster
    # surface area (the culling-quality proxy)
    gx, gy = np.meshgrid(np.arange(40, dtype=np.float32),
                         np.arange(40, dtype=np.float32))
    base = np.stack([gx.ravel(), gy.ravel(), (gx * 0.1 + gy * 0.07).ravel()], -1)
    p0 = jnp.asarray(base)
    p1 = jnp.asarray(base + [0.8, 0.1, 0.0])
    p2 = jnp.asarray(base + [0.1, 0.8, 0.05])
    valid = jnp.ones((base.shape[0],), bool)

    def total_sa(order):
        q0, q1, q2 = (np.asarray(p)[order] for p in (p0, p1, p2))
        boxes = block_aabbs(q0, q1, q2, np.asarray(valid)[order], 64)
        ext = np.maximum(boxes[:, 3:6] - boxes[:, 0:3], 0)
        return float(np.nansum(
            2 * (ext[:, 0] * ext[:, 1] + ext[:, 0] * ext[:, 2]
                 + ext[:, 1] * ext[:, 2])
        ))

    sa_kd = total_sa(kdmedian_order(p0, p1, p2, 64))
    sa_mo = total_sa(morton_order(p0, p1, p2))
    assert sa_kd <= sa_mo


def test_any_hit_matches_brute():
    o, d, t_max, p0, p1, p2 = _random_scene(7, n_rays=96, n_tris=21)
    tris = isect.TriangleArrays(p0, p1, p2, jnp.arange(p0.shape[0], dtype=jnp.int32))
    _tt, _b, ok = isect.triangle_intersect_t(o, d, t_max, tris, with_bary=False)
    ref = np.asarray(jnp.any(ok, axis=-1))
    aabbs, valid = _aabbs(p0, p1, p2)
    got = np.asarray(
        tri_any_hit_pallas(o, d, t_max, p0, p1, p2, valid, aabbs, interpret=True)
    )
    np.testing.assert_array_equal(got, ref)


def test_padding_lanes_are_misses():
    """Padded rays/tris must not alias into real lanes."""
    o, d, t_max, p0, p1, p2 = _random_scene(3, n_rays=5, n_tris=3)
    valid = jnp.array([True, False, True])
    aabbs, _ = _aabbs(p0, p1, p2, valid)
    t, idx = tri_closest_hit_pallas(o, d, t_max, p0, p1, p2, valid, aabbs,
                                    interpret=True)
    assert t.shape == (5,) and idx.shape == (5,)
    assert not np.any(np.asarray(idx) == 1)  # invalid tri never wins


def test_aggregate_matches_brute_on_mesh():
    """Full pallas aggregate (Morton + clusters + attributes) vs brute on a
    multi-block mesh with spheres."""
    from curry_pbrt_tpu.ops.pallas.aggregate import make_pallas_intersectors

    o, d, t_max, p0, p1, p2 = _random_scene(13, n_rays=128, n_tris=260, spread=4.0)
    tris = isect.TriangleArrays(p0, p1, p2, jnp.arange(260, dtype=jnp.int32))
    sph = isect.SphereArrays(
        jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (1, 4, 4)),
        jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (1, 4, 4)),
        jnp.asarray([1.2], jnp.float32),
        jnp.asarray([260], jnp.int32),
    )
    inter, pred, tprim = make_pallas_intersectors(tris, sph)
    got = inter(o, d, t_max)
    ref = isect.intersect_brute(o, d, t_max, tris=tris, sph=sph)
    np.testing.assert_array_equal(np.asarray(got.prim), np.asarray(ref.prim))
    hit = np.asarray(ref.prim) >= 0
    np.testing.assert_allclose(
        np.asarray(got.t)[hit], np.asarray(ref.t)[hit], rtol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(got.p)[hit], np.asarray(ref.p)[hit], rtol=1e-4, atol=1e-5
    )
    np.testing.assert_array_equal(np.asarray(pred(o, d, t_max)),
                                  np.asarray(isect.intersect_predicate_brute(
                                      o, d, t_max, tris=tris, sph=sph)))
    # slim (t, prim) path agrees with the full intersect
    t2, prim2 = tprim(o, d, t_max)
    np.testing.assert_array_equal(np.asarray(prim2), np.asarray(ref.prim))
    np.testing.assert_allclose(
        np.asarray(t2)[hit], np.asarray(ref.t)[hit], rtol=1e-6
    )


def _tables_closest(o, d, t_max, tables, block_r=64):
    from curry_pbrt_tpu.ops.pallas.intersect_kernel import tri_closest_hit_tables

    return tri_closest_hit_tables(
        o, d, t_max,
        jnp.asarray(tables.tri_rows), jnp.asarray(tables.cluster_aabbs),
        jnp.asarray(tables.super_aabbs), jnp.asarray(tables.slab_aabbs),
        block_t=tables.block_t, clusters_per_slab=tables.clusters_per_slab,
        use_supers=tables.use_supers, interpret=True, block_r=block_r,
    )


@pytest.mark.parametrize("cps,use_supers", [(16, True), (16, False), (8, False)])
def test_multislab_streaming_matches_brute(cps, use_supers):
    """Multi-slab hierarchy + super-cluster level vs brute: 1.9k tris →
    30 clusters → 2-4 slabs at clusters_per_slab=8/16; exercises the
    cross-slab t tightening and the slab/super AABB skips."""
    from curry_pbrt_tpu.ops.pallas.intersect_kernel import build_tri_tables

    o, d, t_max, p0, p1, p2 = _random_scene(21, n_rays=256, n_tris=1900, spread=6.0)
    tris = isect.TriangleArrays(p0, p1, p2, jnp.arange(1900, dtype=jnp.int32))
    tables = build_tri_tables(
        p0, p1, p2, tris.prim, block_t=64,
        view_origin=np.array([0.0, 0.0, -10.0]),
        clusters_per_slab=cps, use_supers=use_supers,
    )
    assert tables.n_slabs >= 2

    t, idx = _tables_closest(o, d, t_max, tables)
    t, idx = np.asarray(t), np.asarray(idx)

    # brute reference in chunks (dense (N,T) is fine at this size)
    tt, _b, ok = isect.triangle_intersect_t(o, d, t_max, tris)
    ref_t = np.asarray(jnp.min(tt, axis=-1))
    ref_any = np.asarray(jnp.any(ok, axis=-1))

    assert np.array_equal(idx >= 0, ref_any)
    # same math, but XLA fuses FMAs differently between the two lowerings
    # and the compounding through the edge functions reaches ~10 ulps on
    # small t values (observed 1.1e-6 relative at t=0.028)
    np.testing.assert_allclose(t[ref_any], ref_t[ref_any], rtol=5e-6, atol=0)
    # winner rows map to real prims and reproduce the winning t
    prim_of = np.asarray(tables.prim)
    assert (prim_of[idx[ref_any]] >= 0).all()
    tt = np.asarray(tt)
    for i in np.nonzero(ref_any)[0]:
        np.testing.assert_allclose(
            tt[i, prim_of[idx[i]]], ref_t[i], rtol=5e-6, atol=0
        )


def test_multislab_any_hit_matches_brute():
    from curry_pbrt_tpu.ops.pallas.intersect_kernel import (
        build_tri_tables,
        tri_any_hit_tables,
    )

    o, d, t_max, p0, p1, p2 = _random_scene(22, n_rays=256, n_tris=1100, spread=6.0)
    tris = isect.TriangleArrays(p0, p1, p2, jnp.arange(1100, dtype=jnp.int32))
    _tt, _b, ok = isect.triangle_intersect_t(o, d, t_max, tris, with_bary=False)
    ref = np.asarray(jnp.any(ok, axis=-1))
    tables = build_tri_tables(
        p0, p1, p2, tris.prim, block_t=64, clusters_per_slab=8, use_supers=False
    )
    assert tables.n_slabs >= 2
    got = np.asarray(
        tri_any_hit_tables(
            o, d, t_max,
            jnp.asarray(tables.tri_rows), jnp.asarray(tables.cluster_aabbs),
            jnp.asarray(tables.super_aabbs), jnp.asarray(tables.slab_aabbs),
            block_t=tables.block_t, clusters_per_slab=tables.clusters_per_slab,
            use_supers=tables.use_supers, interpret=True, block_r=64,
        )
    )
    np.testing.assert_array_equal(got, ref)


def test_build_tri_tables_is_permutation_with_padding():
    _o, _d, _t, p0, p1, p2 = _random_scene(23, n_tris=777, spread=3.0)
    from curry_pbrt_tpu.ops.pallas.intersect_kernel import build_tri_tables

    tables = build_tri_tables(
        p0, p1, p2, np.arange(777, dtype=np.int32), block_t=64,
        view_origin=np.array([1.0, 2.0, 3.0]), use_supers=True,
    )
    real = tables.prim[tables.prim >= 0]
    assert sorted(real.tolist()) == list(range(777))
    # vertex rows follow their prim ids through the permutation
    src = np.asarray(p0)
    np.testing.assert_array_equal(tables.p0[tables.valid], src[real])
    # AABB levels contain their children
    ca = tables.cluster_aabbs
    assert tables.use_supers
    sa = tables.super_aabbs
    from curry_pbrt_tpu.ops.pallas.intersect_kernel import SUPER_G

    grouped = ca.reshape(sa.shape[0], SUPER_G, 8)
    ok_rows = ~np.isnan(grouped[..., 0])
    for s in range(sa.shape[0]):
        for c in range(SUPER_G):
            if ok_rows[s, c]:
                assert (grouped[s, c, 0:3] >= sa[s, 0:3] - 1e-6).all()
                assert (grouped[s, c, 3:6] <= sa[s, 3:6] + 1e-6).all()


def test_600k_tri_scene_matches_brute_subsample():
    """Scene-size ceiling: the slab hierarchy must handle 620k tris
    (scenes/torus600k.ply scale — reference renders any PLY that fits RAM,
    plymesh.rs:49-131). Synthetic torus, 64 probe rays, brute reference
    computed in triangle chunks to bound memory."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    from make_mesh_scene import bumpy_torus
    from curry_pbrt_tpu.ops.pallas.intersect_kernel import build_tri_tables

    idx, verts = bumpy_torus(nu=775, nv=400)
    tri = verts[idx.reshape(-1, 3)]
    p0, p1, p2 = (jnp.asarray(tri[:, k]) for k in range(3))
    n_tris = tri.shape[0]
    assert n_tris >= 600_000

    rng = np.random.default_rng(31)
    # probe rays from a viewpoint ring, aimed at torus points (mixed
    # coherence: some culling, some deep sweeps)
    theta = rng.uniform(0, 2 * np.pi, 64)
    o = np.stack([3.0 * np.cos(theta), rng.uniform(-1, 2, 64), 3.0 * np.sin(theta)],
                 -1).astype(np.float32)
    aim = tri[rng.integers(0, n_tris, 64), 0]
    d = aim - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o_j, d_j = jnp.asarray(o), jnp.asarray(d)
    t_max = jnp.full((64,), 100.0, jnp.float32)

    tables = build_tri_tables(p0, p1, p2, np.arange(n_tris, dtype=np.int32),
                              block_t=64, view_origin=np.array([0.0, 0.0, -4.0]))
    assert tables.n_slabs > 2  # actually exercises the slab level
    t, widx = map(np.asarray, _tables_closest(o_j, d_j, t_max, tables, block_r=64))

    # chunked brute reference (dense (64, T) would be ~160 MB per temp)
    ref_t = np.full((64,), np.inf, np.float32)
    ref_any = np.zeros((64,), bool)
    step = 65536
    for lo in range(0, n_tris, step):
        sub = isect.TriangleArrays(
            p0[lo:lo + step], p1[lo:lo + step], p2[lo:lo + step],
            jnp.arange(min(step, n_tris - lo), dtype=jnp.int32),
        )
        tt, _b, ok = isect.triangle_intersect_t(o_j, d_j, t_max, sub)
        ref_t = np.minimum(ref_t, np.asarray(jnp.min(tt, axis=-1)))
        ref_any |= np.asarray(jnp.any(ok, axis=-1))

    assert np.array_equal(widx >= 0, ref_any)
    np.testing.assert_allclose(t[ref_any], ref_t[ref_any], rtol=5e-6, atol=0)


def test_subgroup_predication_matches_brute():
    """Culling granularity is the program's ray block: its size must only
    change how much work is skipped, never the results."""
    from curry_pbrt_tpu.ops.pallas.intersect_kernel import (
        build_tri_tables,
        tri_any_hit_tables,
        tri_closest_hit_tables,
    )

    o, d, t_max, p0, p1, p2 = _random_scene(41, n_rays=700, n_tris=1300, spread=5.0)
    tris = isect.TriangleArrays(p0, p1, p2, jnp.arange(1300, dtype=jnp.int32))
    tables = build_tri_tables(p0, p1, p2, tris.prim, block_t=64,
                              view_origin=np.array([0.0, 0.0, -9.0]),
                              use_supers=True)
    args = (jnp.asarray(tables.tri_rows), jnp.asarray(tables.cluster_aabbs),
            jnp.asarray(tables.super_aabbs), jnp.asarray(tables.slab_aabbs))
    kw = dict(block_t=tables.block_t,
              clusters_per_slab=tables.clusters_per_slab,
              use_supers=tables.use_supers, interpret=True)
    t1, i1 = tri_closest_hit_tables(o, d, t_max, *args, block_r=32, **kw)
    t4, i4 = tri_closest_hit_tables(o, d, t_max, *args, block_r=128, **kw)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i4))
    np.testing.assert_array_equal(np.asarray(t1), np.asarray(t4))
    h1 = tri_any_hit_tables(o, d, t_max, *args, block_r=32, **kw)
    h4 = tri_any_hit_tables(o, d, t_max, *args, block_r=128, **kw)
    np.testing.assert_array_equal(np.asarray(h1), np.asarray(h4))


def test_stats_outputs_do_not_change_results():
    """stats=True (the executed-work counters) must return the same
    (t, idx) plus sane entered/improved counters."""
    from curry_pbrt_tpu.ops.pallas.intersect_kernel import (
        build_tri_tables,
        tri_closest_hit_tables,
    )

    o, d, t_max, p0, p1, p2 = _random_scene(51, n_rays=300, n_tris=900, spread=4.0)
    tables = build_tri_tables(p0, p1, p2, np.arange(900, dtype=np.int32),
                              block_t=64, use_supers=True)
    args = (jnp.asarray(tables.tri_rows), jnp.asarray(tables.cluster_aabbs),
            jnp.asarray(tables.super_aabbs), jnp.asarray(tables.slab_aabbs))
    kw = dict(block_t=tables.block_t,
              clusters_per_slab=tables.clusters_per_slab,
              use_supers=tables.use_supers, interpret=True, block_r=64)
    t0, i0 = tri_closest_hit_tables(o, d, t_max, *args, **kw)
    t1, i1, entered, improved = tri_closest_hit_tables(
        o, d, t_max, *args, stats=True, **kw
    )
    np.testing.assert_array_equal(np.asarray(t0), np.asarray(t1))
    np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))
    entered, improved = np.asarray(entered), np.asarray(improved)
    n_clusters = tables.cluster_aabbs.shape[0]
    assert entered.sum() > 0
    # per-lane test counts are bounded by the cluster count
    assert entered.max() <= n_clusters
    # a hit implies at least one improving test somewhere
    assert improved.sum() > 0
    assert (improved <= entered).all()
