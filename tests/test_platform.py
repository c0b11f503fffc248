"""Platform plumbing: the Pallas route per backend, the GPU intersector
rule, the compile-cache location, and the Triton wrapper's checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import curry_pbrt_tpu.render as R
from curry_pbrt_tpu.ops.pallas import intersect_kernel as ik
from curry_pbrt_tpu.sceneio.compiler import compile_scene_string
from curry_pbrt_tpu.utils.cache import REPO_ROOT, compile_cache_dir


@pytest.mark.parametrize("backend,expected", [("cpu", True), ("gpu", False)])
def test_interpret_only_on_cpu(monkeypatch, backend, expected):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert ik.interpret_mode() is expected


@pytest.mark.parametrize("backend", ["rocm", "metal", "neuron"])
def test_other_platforms_raise(monkeypatch, backend):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    with pytest.raises(RuntimeError, match="no compiled Pallas route"):
        ik.interpret_mode()


def _scene_with_tris(n_tris):
    pts = " ".join(f"{i} 0 5  {i} 1 5  {i + 0.5} 0 5" for i in range(n_tris))
    idx = " ".join(f"{3 * i} {3 * i + 1} {3 * i + 2}" for i in range(n_tris))
    return compile_scene_string(f"""
Film "image" "integer xresolution" [4] "integer yresolution" [4]
Camera "perspective" "float fov" [40]
WorldBegin
LightSource "point" "rgb I" [1 1 1]
Material "matte" "rgb Kd" [0.5 0.5 0.5]
Shape "trianglemesh" "integer indices" [{idx}] "point P" [{pts}]
WorldEnd
""", overrides={"clip": False})


@pytest.mark.parametrize("n_prims,gpu_choice,cpu_choice", [
    (R.GPU_BRUTE_MAX_PRIMS, "brute", "brute"),
    (R.GPU_BRUTE_MAX_PRIMS + 1, "pallas", "brute"),
    (300, "pallas", "bvh"),
])
def test_default_backend_rule(monkeypatch, n_prims, gpu_choice, cpu_choice):
    # the empty sphere table keeps one padding row, which counts
    scene = _scene_with_tris(n_prims - 1)
    assert scene.tris.count + scene.spheres.count == n_prims
    assert R.default_backend(scene) == cpu_choice  # the test platform
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert R.default_backend(scene) == gpu_choice


def test_compile_cache_dir_follows_env():
    assert compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x/cache"}).as_posix() == "/x/cache"
    assert compile_cache_dir({}) == REPO_ROOT / ".jax_cache"
    assert compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": ""}) == REPO_ROOT / ".jax_cache"
    assert (REPO_ROOT / "curry_pbrt_tpu").is_dir()


def _tables(n_tris=100, block_t=16):
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(n_tris, 3)).astype(np.float32)
    return ik.build_tri_tables(p0, p0 + 0.1, p0 + np.float32([0.1, 0, 0.2]),
                               np.arange(n_tris, dtype=np.int32),
                               block_t=block_t)


@pytest.mark.parametrize("block_r,block_t", [(48, 16), (32, 24), (0, 16)])
def test_wrapper_rejects_non_pow2_blocks(block_r, block_t):
    tab = _tables()
    args = tuple(jnp.asarray(a) for a in (
        tab.tri_rows, tab.cluster_aabbs, tab.super_aabbs, tab.slab_aabbs))
    o = jnp.zeros((8, 3))
    d = jnp.ones((8, 3))
    with pytest.raises(ValueError, match="power of two"):
        ik.tri_closest_hit_tables(
            o, d, jnp.ones((8,)), *args, block_t=block_t,
            clusters_per_slab=tab.clusters_per_slab,
            use_supers=tab.use_supers, interpret=True, block_r=block_r)


def test_wrapper_rejects_table_shape_mismatch():
    tab = _tables()
    args = [jnp.asarray(a) for a in (
        tab.tri_rows, tab.cluster_aabbs, tab.super_aabbs, tab.slab_aabbs)]
    args[0] = args[0][:, :-16]  # one cluster's columns short
    with pytest.raises(ValueError, match="does not hold"):
        ik.tri_any_hit_tables(
            jnp.zeros((8, 3)), jnp.ones((8, 3)), jnp.ones((8,)), *args,
            block_t=tab.block_t, clusters_per_slab=tab.clusters_per_slab,
            use_supers=tab.use_supers, interpret=True)


@pytest.mark.parametrize("n_rays", [1, 31, 32, 33, 100])
def test_ray_padding_and_output_shapes(n_rays):
    """Rays pad to whole blocks with t_max = 0 (never entering anything);
    outputs come back unpadded."""
    rays = ik.pack_rays(jnp.zeros((n_rays, 3)), jnp.ones((n_rays, 3)),
                        jnp.ones((n_rays,)), block_r=32)
    assert rays.shape == (ik.RAY_ROWS, -(-n_rays // 32) * 32)
    assert not np.asarray(rays[6, n_rays:]).any()
    tab = _tables()
    args = tuple(jnp.asarray(a) for a in (
        tab.tri_rows, tab.cluster_aabbs, tab.super_aabbs, tab.slab_aabbs))
    kw = dict(block_t=tab.block_t, clusters_per_slab=tab.clusters_per_slab,
              use_supers=tab.use_supers, interpret=True, block_r=32)
    o = jnp.zeros((n_rays, 3))
    d = jnp.ones((n_rays, 3)) / np.sqrt(3)
    t, idx = ik.tri_closest_hit_tables(o, d, jnp.full((n_rays,), 1e30), *args, **kw)
    hit = ik.tri_any_hit_tables(o, d, jnp.full((n_rays,), 1e30), *args, **kw)
    assert t.shape == idx.shape == hit.shape == (n_rays,)


def test_tables_pad_to_whole_clusters_and_slabs():
    tab = ik.build_tri_tables(*(np.random.default_rng(1).normal(
        size=(3, 1000, 3)).astype(np.float32)), np.arange(1000, dtype=np.int32),
        block_t=16, clusters_per_slab=16, use_supers=True)
    nc = tab.cluster_aabbs.shape[0]
    assert nc % tab.clusters_per_slab == 0 and nc % ik.SUPER_G == 0
    assert tab.tri_rows.shape == (ik.TRI_ROWS, nc * 16)
    assert (tab.tri_rows[9] > 0).sum() == 1000  # valid flags
    assert tab.super_aabbs.shape == (nc // ik.SUPER_G, 8)
    assert tab.slab_aabbs.shape == (nc // 16, 8)
    with pytest.raises(ValueError, match="power of two"):
        ik.build_tri_tables(tab.p0, tab.p1, tab.p2, tab.prim, block_t=24)
