"""C++ SAH builder vs numpy fallback: both must produce structurally valid
flat BVHs that traverse to identical hits (whichever builder CI exercises, the other
would otherwise go untested)."""

import numpy as np
import jax.numpy as jnp
import pytest

from curry_pbrt_tpu.ops import bvh as BV
from curry_pbrt_tpu.ops import bvh_native
from curry_pbrt_tpu.ops.intersect import TriangleArrays, empty_spheres


def _random_tris(n, seed, spread=10.0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    p0 = base
    p1 = base + rng.normal(0, 0.8, (n, 3)).astype(np.float32)
    p2 = base + rng.normal(0, 0.8, (n, 3)).astype(np.float32)
    return p0, p1, p2


class _FakeScene:
    def __init__(self, p0, p1, p2):
        self.tris = TriangleArrays(
            jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(p2),
            jnp.arange(p0.shape[0], dtype=jnp.int32),
        )
        self.spheres = empty_spheres()


def _build_both(p0, p1, p2, monkeypatch):
    scene = _FakeScene(p0, p1, p2)
    native = BV.build_flat_bvh(scene)
    monkeypatch.setattr(bvh_native, "sah_build_flat", lambda *a, **k: None)
    numpy_bvh = BV.build_flat_bvh(scene)
    return scene, native, numpy_bvh


def _check_structure(bvh, n_prims):
    hit = np.asarray(bvh.hit)
    miss = np.asarray(bvh.miss)
    first = np.asarray(bvh.first)
    count = np.asarray(bvh.count)
    M = bvh.n_nodes
    assert hit.min() >= -1 and hit.max() < M
    assert miss.min() >= -1 and miss.max() < M
    # hit-walk (DFS spine) terminates and visits each node at most once
    ptr, steps = 0, 0
    while ptr != -1 and steps <= M:
        ptr = hit[ptr]
        steps += 1
    assert ptr == -1, "hit-link cycle"
    # every primitive slot appears exactly once across leaves
    leaf = first >= 0
    slots = np.concatenate(
        [np.arange(f, f + c) for f, c in zip(first[leaf], count[leaf])]
    )
    assert sorted(slots.tolist()) == list(range(n_prims))
    assert sorted(np.asarray(bvh.prim_refs).tolist()) == list(range(n_prims))


@pytest.mark.skipif(not bvh_native.available(), reason="native builder not built")
@pytest.mark.parametrize("n", [10, 257, 5000])
def test_native_and_numpy_builders_traverse_identically(n, monkeypatch):
    p0, p1, p2 = _random_tris(n, seed=n)
    scene, native, numpy_bvh = _build_both(p0, p1, p2, monkeypatch)
    _check_structure(native, n)
    _check_structure(numpy_bvh, n)

    rng = np.random.default_rng(99)
    o_np = rng.uniform(-15, 15, (256, 3)).astype(np.float32)
    # aim half the rays at random triangle centroids so sparse scenes still
    # produce hits to compare
    cent = ((p0 + p1 + p2) / 3.0)[rng.integers(0, len(p0), 128)]
    d_np = rng.normal(0, 1, (256, 3)).astype(np.float32)
    d_np[:128] = cent - o_np[:128]
    d_np /= np.linalg.norm(d_np, axis=-1, keepdims=True)
    o, d = jnp.asarray(o_np), jnp.asarray(d_np)
    t_max = jnp.full((256,), 1e30, jnp.float32)

    tn, rn = BV.bvh_traverse(native, scene.tris, scene.spheres, o, d, t_max)
    tp, rp = BV.bvh_traverse(numpy_bvh, scene.tris, scene.spheres, o, d, t_max)
    # prim_refs differ in order between builders; compare the primitive IDs
    ref_n = np.where(np.asarray(rn) >= 0, np.asarray(rn), -1)
    ref_p = np.where(np.asarray(rp) >= 0, np.asarray(rp), -1)
    id_n = np.where(ref_n >= 0, np.asarray(native.prim_refs)[np.maximum(ref_n, 0)], -1)
    id_p = np.where(ref_p >= 0, np.asarray(numpy_bvh.prim_refs)[np.maximum(ref_p, 0)], -1)
    hit_mask = id_n >= 0
    np.testing.assert_array_equal(hit_mask, id_p >= 0)
    np.testing.assert_allclose(
        np.asarray(tn)[hit_mask], np.asarray(tp)[hit_mask], rtol=1e-6
    )
    # same winning primitive wherever the closest t is unique
    assert hit_mask.any()
    close = np.isclose(np.asarray(tn), np.asarray(tp), rtol=1e-6)
    assert (id_n[hit_mask & close] == id_p[hit_mask & close]).mean() > 0.99


def test_numpy_builder_deep_chained_leaves(monkeypatch):
    """Clustered prims force oversized SAH leaves → chained fixed-width leaf
    nodes; 5k prims also covers the recursion-limit bump path."""
    rng = np.random.default_rng(5)
    # 5000 tris stacked in 10 dense clumps — SAH can't split clumps well
    centers = rng.uniform(-50, 50, (10, 3))
    base = (centers[rng.integers(0, 10, 5000)] +
            rng.normal(0, 0.01, (5000, 3))).astype(np.float32)
    p1 = base + rng.normal(0, 0.02, (5000, 3)).astype(np.float32)
    p2 = base + rng.normal(0, 0.02, (5000, 3)).astype(np.float32)
    scene = _FakeScene(base, p1, p2)
    monkeypatch.setattr(bvh_native, "sah_build_flat", lambda *a, **k: None)
    bvh = BV.build_flat_bvh(scene)
    _check_structure(bvh, 5000)
    assert int(np.asarray(bvh.count).max()) <= BV.LEAF_SIZE
