"""Direct-lighting integrator: the reference enumerates every delta branch
per ray (direct_light.rs:12-42); we follow ONE luminance-weighted branch per
lane (unbiased, O(depth) batch traces). These tests pin
the estimator's behavior."""

import numpy as np
import pytest

from curry_pbrt_tpu.render import render_scene
from curry_pbrt_tpu.sceneio.compiler import compile_scene_string

MIRROR_SCENE = """
Film "image" "integer xresolution" [24] "integer yresolution" [24]
Sampler "halton" "integer pixelsamples" [%d]
Camera "perspective" "float fov" [50]
Integrator "directlighting" "integer maxdepth" [3]
WorldBegin
# mirror tilted 45deg: camera looks +z, sees the emissive patch above
Material "mirror"
Shape "trianglemesh" "integer indices" [0 1 2 2 3 0]
  "point P" [-2 -1 3   2 -1 3   2 1 5   -2 1 5]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [5 5 5]
  Shape "trianglemesh" "integer indices" [0 1 2 2 3 0]
    "point P" [-2 3 2   2 3 2   2 3 6   -2 3 6]
AttributeEnd
WorldEnd
"""

GLASS_SCENE = """
Film "image" "integer xresolution" [24] "integer yresolution" [24]
Sampler "halton" "integer pixelsamples" [%d]
Camera "perspective" "float fov" [55]
Integrator "directlighting" "integer maxdepth" [4]
WorldBegin
AttributeBegin
  Translate 0 2.5 3
  LightSource "point" "rgb I" [30 30 30]
AttributeEnd
Material "glass"
AttributeBegin
  Translate 0 0 3
  Shape "sphere" "float radius" [0.8]
AttributeEnd
Material "matte" "rgb Kd" [0.6 0.6 0.6]
Shape "trianglemesh" "integer indices" [0 1 2 2 3 0]
  "point P" [-5 -1.2 0   5 -1.2 0   5 -1.2 9   -5 -1.2 9]
WorldEnd
"""


def _render(text, spp, seed=0):
    scene = compile_scene_string(text % spp, overrides={"clip": False, "seed": seed})
    return render_scene(scene, show_progress=False)


class TestMirrorBranch:
    def test_mirror_reflects_light(self):
        """Single delta lobe ⇒ the stochastic choice is deterministic
        (p = 1) and must find the emitter through the mirror."""
        img = _render(MIRROR_SCENE, 4)
        assert not np.isnan(img).any()
        assert img.max() > 1.0  # emitter visible via the specular bounce

    def test_deterministic(self):
        a = _render(MIRROR_SCENE, 2)
        b = _render(MIRROR_SCENE, 2)
        np.testing.assert_array_equal(a, b)


class TestGlassStochastic:
    def test_depth4_runs_linear_not_exponential(self):
        """Glass has 2 delta lobes; depth 4 used to cost 2^4 batch renders.
        The stochastic estimator is one trace per level — this render
        completing quickly (and finitely) is the regression guard."""
        img = _render(GLASS_SCENE, 4)
        assert not np.isnan(img).any()
        assert img.mean() > 0.0

    def test_spp_consistency_unbiased(self):
        """Estimator mean must be stable across sample counts (unbiasedness
        smoke test: doubling spp only reduces variance)."""
        lo = _render(GLASS_SCENE, 16)
        hi = _render(GLASS_SCENE, 64)
        m_lo, m_hi = float(lo.mean()), float(hi.mean())
        assert abs(m_lo - m_hi) / max(m_hi, 1e-9) < 0.12, (m_lo, m_hi)
