"""Image textures: loading, nearest lookup with v-flip, and texture-space
gradients (BASELINE.json config 4: optimize an albedo TEXTURE from a target
image)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from curry_pbrt_tpu.render import plan_render, _render_chunk, render_scene
from curry_pbrt_tpu.sceneio.compiler import compile_scene_file
from curry_pbrt_tpu.utils.imageio import write_png, read_image


@pytest.fixture(scope="module")
def textured_scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("tex")
    rng = np.random.RandomState(0)
    tex = (rng.rand(8, 8, 3) * 200 + 30).astype(np.uint8)
    write_png(d / "checker.png", tex)
    scene_text = """
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Sampler "halton" "integer pixelsamples" [4]
Camera "perspective" "float fov" [60]
Integrator "path" "integer maxdepth" [1]
WorldBegin
AttributeBegin
  Translate 0 1 1
  LightSource "point" "rgb I" [8 8 8]
AttributeEnd
Texture "tex" "spectrum" "imagemap" "string filename" ["checker.png"]
Material "matte" "texture Kd" ["tex"]
Shape "trianglemesh" "integer indices" [0 1 2 2 3 0]
  "point P" [-4 -1 0   4 -1 0   4 -1 8   -4 -1 8]
WorldEnd
"""
    (d / "scene.pbrt").write_text(scene_text)
    return compile_scene_file(d / "scene.pbrt", overrides={"clip": False})


class TestTextureScoping:
    """Reference scopes texture maps per attribute block (scene.rs:51-56):
    materials bind the texture definition visible in THEIR scope at compile
    time, not the last one globally."""

    @staticmethod
    def _write_tex(path, value_u8):
        img = np.full((4, 4, 3), value_u8, np.uint8)
        write_png(path, img)

    def _scene(self, d):
        self._write_tex(d / "bright.png", 230)
        self._write_tex(d / "dark.png", 25)
        text = """
Film "image" "integer xresolution" [8] "integer yresolution" [8]
Sampler "halton" "integer pixelsamples" [1]
Camera "perspective" "float fov" [60]
Integrator "path" "integer maxdepth" [1]
WorldBegin
AttributeBegin
  Texture "t" "spectrum" "imagemap" "string filename" ["bright.png"]
  Material "matte" "texture Kd" ["t"]
  Shape "trianglemesh" "integer indices" [0 1 2]
    "point P" [-1 -1 2   1 -1 2   0 1 2]
AttributeEnd
AttributeBegin
  Texture "t" "spectrum" "imagemap" "string filename" ["dark.png"]
  Material "matte" "texture Kd" ["t"]
  Shape "trianglemesh" "integer indices" [0 1 2]
    "point P" [-1 -1 3   1 -1 3   0 1 3]
AttributeEnd
WorldEnd
"""
        (d / "scene.pbrt").write_text(text)
        return compile_scene_file(d / "scene.pbrt", overrides={"clip": False})

    def test_sibling_scopes_bind_distinct_files(self, tmp_path):
        scene = self._scene(tmp_path)
        assert len(scene.init_params["textures"]) == 2
        # the two matte materials must reference DIFFERENT store keys
        keys = set()
        for mat in scene.materials:
            ref = mat.refs["Kd"]
            assert ref.kind == "texture"
            keys.add(ref.tex)
            assert ref.tex in scene.init_params["textures"]
        assert len(keys) == 2
        bound = {
            float(np.asarray(scene.init_params["textures"][k]).mean()) for k in keys
        }
        assert min(bound) < 0.05 and max(bound) > 0.5  # dark and bright

    def test_undefined_texture_raises(self, tmp_path):
        text = """
WorldBegin
Material "matte" "texture Kd" ["nosuch"]
Shape "trianglemesh" "integer indices" [0 1 2] "point P" [0 0 2 1 0 2 0 1 2]
WorldEnd
"""
        (tmp_path / "bad.pbrt").write_text(text)
        with pytest.raises(ValueError, match="undefined texture"):
            compile_scene_file(tmp_path / "bad.pbrt")

    def test_mix_with_textured_amount(self, tmp_path):
        """`mix` whose amount is a texture must resolve and render
        (it once raised KeyError at trace time)."""
        self._write_tex(tmp_path / "amt.png", 128)
        text = """
Film "image" "integer xresolution" [8] "integer yresolution" [8]
Sampler "halton" "integer pixelsamples" [2]
Camera "perspective" "float fov" [60]
Integrator "path" "integer maxdepth" [1]
WorldBegin
AttributeBegin
  Translate 0 1 1
  LightSource "point" "rgb I" [8 8 8]
AttributeEnd
Texture "amt" "spectrum" "imagemap" "string filename" ["amt.png"]
MakeNamedMaterial "a" "string type" ["matte"] "rgb Kd" [0.9 0.1 0.1]
MakeNamedMaterial "b" "string type" ["matte"] "rgb Kd" [0.1 0.1 0.9]
Material "mix" "texture amount" ["amt"]
  "string namedmaterial1" ["a"] "string namedmaterial2" ["b"]
Shape "trianglemesh" "integer indices" [0 1 2 2 3 0]
  "point P" [-4 -1 0   4 -1 0   4 -1 8   -4 -1 8]
WorldEnd
"""
        (tmp_path / "mix.pbrt").write_text(text)
        scene = compile_scene_file(tmp_path / "mix.pbrt", overrides={"clip": False})
        amt_ref = next(m for m in scene.materials if m.kind == "mix").refs["amount"]
        assert amt_ref.kind == "texture" and amt_ref.tex in scene.init_params["textures"]
        img = render_scene(scene, show_progress=False)
        assert not np.isnan(img).any()
        assert img.max() > 0


class TestImageTexture:
    def test_texture_loaded_inverse_gamma(self, textured_scene):
        scene = textured_scene
        assert len(scene.init_params["textures"]) == 1
        tex = np.asarray(next(iter(scene.init_params["textures"].values())))
        assert tex.shape == (8, 8, 3)
        # spectrum textures are stored inverse-gamma'd → darker than raw
        assert tex.mean() < (30 + 200 / 2) / 255.0

    def test_render_picks_up_texture(self, textured_scene):
        img = render_scene(textured_scene, show_progress=False)
        assert not np.isnan(img).any()
        assert img.max() > 0  # lit floor visible

    def test_texture_gradients_flow_to_texels(self, textured_scene):
        scene = textured_scene
        plan = plan_render(scene, chunk_pixels=256)
        xres, yres = scene.settings.resolution
        ys, xs = np.mgrid[0:yres, 0:xres]
        px = jnp.asarray(np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32))
        po = jnp.asarray(plan.pixel_offsets.reshape(-1))

        def loss(p):
            return jnp.sum(_render_chunk(plan, p, po, px))

        g = jax.jit(jax.grad(loss))(scene.init_params)
        key = next(iter(g["textures"]))
        gt = np.asarray(g["textures"][key])
        assert gt.shape == (8, 8, 3)
        assert not np.isnan(gt).any()
        assert (gt > 0).sum() > 4  # multiple visible texels receive gradient

    def test_optimize_texture_recovers_target(self, textured_scene):
        """Config-4: recover texel values from a rendered target image."""
        import optax

        scene = textured_scene
        plan = plan_render(scene, chunk_pixels=256)
        xres, yres = scene.settings.resolution
        ys, xs = np.mgrid[0:yres, 0:xres]
        px = jnp.asarray(np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32))
        po = jnp.asarray(plan.pixel_offsets.reshape(-1))

        target = _render_chunk(plan, scene.init_params, po, px)
        key = next(iter(scene.init_params["textures"]))
        true_tex = np.asarray(scene.init_params["textures"][key])

        params = jax.tree_util.tree_map(lambda x: x, scene.init_params)
        params["textures"] = dict(params["textures"])
        params["textures"][key] = jnp.full((8, 8, 3), 0.5, jnp.float32)

        def loss(p):
            img = _render_chunk(plan, p, po, px)
            return jnp.mean((img - target) ** 2)

        def mask_fn(p):
            return jax.tree_util.tree_map_with_path(
                lambda path, _: any(getattr(k, "key", None) == "textures" for k in path), p
            )

        opt = optax.masked(optax.adam(0.05), mask_fn)
        state = opt.init(params)

        @jax.jit
        def step(p, s):
            l, grads = jax.value_and_grad(loss)(p)
            u, s = opt.update(grads, s, p)
            return optax.apply_updates(p, u), s, l

        # texels visible through the frustum = those with gradient at the
        # (wrong) initialization
        g0 = jax.grad(loss)(params)
        seen = np.abs(np.asarray(g0["textures"][key])).sum(-1) > 0

        for _ in range(200):
            params, state, l = step(params, state)

        got = np.asarray(params["textures"][key])
        if seen.sum() >= 4:
            err = np.abs(got - true_tex)[seen]
            assert err.mean() < 0.05, err.mean()
        assert float(l) < 1e-4
