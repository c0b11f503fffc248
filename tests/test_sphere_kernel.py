"""Sphere cluster kernel (ops/pallas/sphere_kernel.py) vs the dense jnp
path: same math, bit-equal results, at scales where the dense path is the
O(rays × spheres) hole the reference's BVH doesn't have
(aggregate/bvh.rs:24-124)."""

import numpy as np
import jax.numpy as jnp
import pytest

from curry_pbrt_tpu.ops import intersect as isect
from curry_pbrt_tpu.ops.pallas import aggregate
from curry_pbrt_tpu.ops.pallas.aggregate import make_pallas_intersectors


def _random_sphere_arrays(seed, n, spread=12.0, rigid_only=False):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    radii = rng.uniform(0.1, 0.6, n).astype(np.float32)
    o2w = np.zeros((n, 4, 4), np.float32)
    w2o = np.zeros((n, 4, 4), np.float32)
    for i in range(n):
        # random rotation (QR) + optional anisotropic scale + translation
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        if not rigid_only:
            q = q @ np.diag(rng.uniform(0.7, 1.4, 3))
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = q.astype(np.float32)
        m[:3, 3] = centers[i]
        o2w[i] = m
        w2o[i] = np.linalg.inv(m).astype(np.float32)
    prim = np.arange(n, dtype=np.int32)
    return isect.SphereArrays(
        jnp.asarray(o2w), jnp.asarray(w2o), jnp.asarray(radii),
        jnp.asarray(prim),
    )


def _intersectors(monkeypatch, tris, sph, kernel_min):
    """Intersectors with the sphere-kernel threshold at kernel_min: 1
    forces the cluster kernel, a huge value the dense jnp path."""
    monkeypatch.setattr(aggregate, "SPH_KERNEL_MIN", kernel_min)
    return make_pallas_intersectors(tris, sph, view_origin=np.zeros(3))


def _empty_tris():
    z = jnp.zeros((1, 3), jnp.float32)
    return isect.TriangleArrays(z, z, z, jnp.full((1,), -1, jnp.int32))


def _rays(seed, n, spread=14.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full((n,), 1e30, np.float32)
    t_max[: n // 16] = 0.0  # dead lanes
    return jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max)


def test_sphere_kernel_matches_dense_translation(monkeypatch):
    """Translation-only object spaces: same math up to XLA fusing FMAs
    differently between the two lowerings (the tri-kernel tests' last-ULP
    convention) — hit sets and winners must agree exactly, t to ≤2 ULP."""
    rng = np.random.default_rng(0)
    n = 700
    centers = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    radii = rng.uniform(0.1, 0.5, n).astype(np.float32)
    o2w = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    o2w[:, :3, 3] = centers
    w2o = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    w2o[:, :3, 3] = -centers
    sph = isect.SphereArrays(
        jnp.asarray(o2w), jnp.asarray(w2o), jnp.asarray(radii),
        jnp.asarray(np.arange(n, dtype=np.int32)),
    )
    tris = _empty_tris()
    o, d, t_max = _rays(5, 2048)

    i_d, p_d, tp_d = _intersectors(monkeypatch, tris, sph, 999999)
    i_k, p_k, tp_k = _intersectors(monkeypatch, tris, sph, 1)

    hd, hk = i_d(o, d, t_max), i_k(o, d, t_max)
    td_, tk_ = np.asarray(hd.t), np.asarray(hk.t)
    np.testing.assert_array_equal(td_ < 1e30, tk_ < 1e30)
    both = td_ < 1e30
    np.testing.assert_allclose(td_[both], tk_[both], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(np.asarray(hd.prim), np.asarray(hk.prim))
    np.testing.assert_array_equal(
        np.asarray(p_d(o, d, t_max)), np.asarray(p_k(o, d, t_max))
    )
    td, pd_ = tp_d(o, d, t_max)
    tk, pk_ = tp_k(o, d, t_max)
    np.testing.assert_allclose(
        np.asarray(td)[both], np.asarray(tk)[both], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(np.asarray(pd_), np.asarray(pk_))


@pytest.mark.parametrize("n_sph", [300, 1500])
def test_sphere_kernel_matches_dense_affine(monkeypatch, n_sph):
    """General affine object spaces: the dense path's einsum and the
    kernel's explicit fma chain associate the mat-vec differently, which the
    grazing-sensitive quadratic can amplify — so t matches to a tolerance
    and hit/winner flips are allowed only at the tangency boundary (a tiny
    fraction)."""
    sph = _random_sphere_arrays(3, n_sph)
    tris = _empty_tris()
    o, d, t_max = _rays(5, 2048)
    N = o.shape[0]

    i_d, p_d, _ = _intersectors(monkeypatch, tris, sph, 999999)
    i_k, p_k, _ = _intersectors(monkeypatch, tris, sph, 1)

    hd, hk = i_d(o, d, t_max), i_k(o, d, t_max)
    td, tk = np.asarray(hd.t), np.asarray(hk.t)
    hit_d, hit_k = td < 1e30, tk < 1e30
    flips = int((hit_d != hit_k).sum())
    assert flips <= max(2, N // 500), f"{flips} hit flips"
    both = hit_d & hit_k
    np.testing.assert_allclose(td[both], tk[both], rtol=2e-4)
    pr_d, pr_k = np.asarray(hd.prim), np.asarray(hk.prim)
    mism = int((pr_d[both] != pr_k[both]).sum())
    assert mism <= max(2, N // 500), f"{mism} winner mismatches"
    ad, ak = np.asarray(p_d(o, d, t_max)), np.asarray(p_k(o, d, t_max))
    assert int((ad != ak).sum()) <= max(2, N // 500)


def test_sphere_kernel_with_tris_mixed(monkeypatch):
    """Winner merge between the tri kernel and the sphere kernel matches the
    dense-sphere merge."""
    rng = np.random.default_rng(11)
    nt = 80
    p0 = jnp.asarray(rng.uniform(-8, 8, (nt, 3)).astype(np.float32))
    p1 = p0 + jnp.asarray(rng.normal(size=(nt, 3)).astype(np.float32))
    p2 = p0 + jnp.asarray(rng.normal(size=(nt, 3)).astype(np.float32))
    tris = isect.TriangleArrays(p0, p1, p2, jnp.arange(nt, dtype=jnp.int32))
    rng2 = np.random.default_rng(7)
    ns = 400
    centers = rng2.uniform(-8, 8, (ns, 3)).astype(np.float32)
    radii = rng2.uniform(0.1, 0.5, ns).astype(np.float32)
    o2w = np.tile(np.eye(4, dtype=np.float32), (ns, 1, 1))
    o2w[:, :3, 3] = centers
    w2o = np.tile(np.eye(4, dtype=np.float32), (ns, 1, 1))
    w2o[:, :3, 3] = -centers
    sph = isect.SphereArrays(
        jnp.asarray(o2w), jnp.asarray(w2o), jnp.asarray(radii),
        jnp.asarray(np.arange(ns, dtype=np.int32) + nt),
    )
    o, d, t_max = _rays(9, 1024)

    i_d, _, _ = _intersectors(monkeypatch, tris, sph, 999999)
    i_k, _, _ = _intersectors(monkeypatch, tris, sph, 1)
    hd, hk = i_d(o, d, t_max), i_k(o, d, t_max)
    td_, tk_ = np.asarray(hd.t), np.asarray(hk.t)
    np.testing.assert_array_equal(td_ < 1e30, tk_ < 1e30)
    both = td_ < 1e30
    np.testing.assert_allclose(td_[both], tk_[both], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(np.asarray(hd.prim), np.asarray(hk.prim))


def test_sphere_field_scene_end_to_end(tmp_path):
    """A generated 200-sphere scene (above the SPH_KERNEL_MIN=129
    threshold) rendered through the full pipeline: the pallas intersector
    (sphere cluster kernel engaged) must match the brute oracle."""
    from curry_pbrt_tpu.render import render_scene
    from curry_pbrt_tpu.sceneio.compiler import compile_scene_file

    rng = np.random.default_rng(21)
    lines = [
        'LookAt 0 0 -30  0 0 0  0 1 0',
        'Camera "perspective" "float fov" [45]',
        'Sampler "halton" "integer pixelsamples" [1]',
        'Film "image" "integer xresolution" [24] "integer yresolution" [24]',
        'Integrator "path" "integer maxdepth" [2]',
        'WorldBegin',
        'LightSource "distant" "point from" [0 0 -30] "point to" [0 0 0]'
        ' "rgb L" [3 3 3]',
        'Material "matte" "rgb Kd" [0.6 0.5 0.4]',
    ]
    for _ in range(200):
        x, y, z = rng.uniform(-10, 10, 3)
        r = rng.uniform(0.3, 1.0)
        lines += [
            "AttributeBegin",
            f"Translate {x:.4f} {y:.4f} {z:.4f}",
            f'Shape "sphere" "float radius" [{r:.4f}]',
            "AttributeEnd",
        ]
    path = tmp_path / "field.pbrt"
    path.write_text("\n".join(lines) + "\n")

    scene = compile_scene_file(path)
    img_p = render_scene(scene, intersector="pallas", show_progress=False)
    img_b = render_scene(scene, intersector="brute", show_progress=False)
    assert not np.isnan(img_p).any()
    assert img_p.mean() > 0.01  # spheres actually lit
    np.testing.assert_allclose(img_p, img_b, rtol=2e-4, atol=1e-5)


def test_sphere_tables_structure():
    from curry_pbrt_tpu.ops.pallas.sphere_kernel import build_sphere_tables

    sph = _random_sphere_arrays(13, 700)
    tab = build_sphere_tables(
        np.asarray(sph.w2o), np.asarray(sph.o2w), np.asarray(sph.radius),
        np.asarray(sph.prim), view_origin=np.zeros(3),
    )
    rows = tab.row_sphere
    real = rows[rows >= 0]
    assert sorted(real.tolist()) == list(range(700))  # permutation, no loss
    # every valid row's world center is inside its cluster AABB
    nc = tab.cluster_aabbs.shape[0]
    o2w = np.asarray(sph.o2w)
    for c in range(nc):
        rr = rows[c * tab.block_s:(c + 1) * tab.block_s]
        rr = rr[rr >= 0]
        if len(rr) == 0:
            continue
        centers = o2w[rr][:, :3, 3]
        assert np.all(centers >= tab.cluster_aabbs[c, 0:3] - 1e-4)
        assert np.all(centers <= tab.cluster_aabbs[c, 3:6] + 1e-4)
