"""Light table: SoA light arrays + batched sampling/emission ops.

The reference keeps a Vec<Arc<dyn Light>> and virtual-dispatches per ray
(/root/reference/src/light/). Here every light instance becomes a row of a
`LightArrays` SoA table; per-ray operations gather the chosen light's row
and evaluate ALL type formulas under masks (there are only 5 types, each a
few VPU ops — far cheaper than per-instance unrolling, and it scales to
scenes with thousands of emissive triangles).

Type semantics:
  POINT     I/r² falloff, delta           (light/point.rs:28-39)
  DISTANT   fixed direction, delta        (light/distant.rs:28-35)
  AREA_TRI  diffuse emitter over a triangle (light/area.rs + triangle.rs:120-126)
  AREA_SPH  diffuse emitter over a sphere — cone sampling from outside
            (light/area.rs + sphere.rs:66-105)
  INFINITE  env-map with luminance·sinθ importance table
            (light/infinite_area.rs)

Every light's radiance/intensity is a row of params['light_L'] (L,3) — the
differentiable emission parameters.

Divergence note: the reference's InfiniteAreaLight samples its 2-D table
with the row axis fed to φ (infinite_area.rs:53-72) while its escaped-ray
lookup maps rows to θ — a transposition bug; we use the consistent
row=θ/column=φ mapping for both (DESIGN.md).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import jax.numpy as jnp

from curry_pbrt_tpu.dtypes import FLOAT_MAX, Float, gamma
from curry_pbrt_tpu.ops import math as m
from curry_pbrt_tpu.ops.math import safe_sqrt
from curry_pbrt_tpu.ops.distribution import (
    Distribution2D,
    build_distribution_2d,
    pdf_2d_continuous,
    sample_2d_continuous,
)
from curry_pbrt_tpu.ops.intersect import (
    offset_point_by_error,
    sphere_uv,
    transform_shape_point,
)

TYPE_POINT, TYPE_DISTANT, TYPE_AREA_TRI, TYPE_AREA_SPH, TYPE_INFINITE = range(5)

_G5 = gamma(5)
_G6 = gamma(6)


class LightArrays(NamedTuple):
    """(L,) rows; unused fields hold zeros for other types.

    Convention: HOST numpy arrays (the scene compiler builds them and they
    enter jit as constants — no device round trips at plan time, and traced
    indexing of tiny tables is a known bug source)."""

    type_id: np.ndarray  # (L,) i32
    is_delta: np.ndarray  # (L,) bool
    # point: position / distant: unit direction w (light travels along +w)
    vec: np.ndarray  # (L,3)
    # area-tri world-space vertices
    tri_p0: np.ndarray  # (L,3)
    tri_p1: np.ndarray
    tri_p2: np.ndarray
    # area-sphere object space
    sph_o2w: np.ndarray  # (L,4,4)
    sph_w2o: np.ndarray
    sph_radius: np.ndarray  # (L,)
    area: np.ndarray  # (L,) object-space area (tri or sphere)
    # infinite lights: index into the scene's env-map list (-1 otherwise).
    # The reference parses any number of infinite lights
    # (light/mod.rs:43-64); each keeps its own map + importance table.
    env_id: np.ndarray  # (L,) i32

    @property
    def count(self) -> int:
        return int(self.type_id.shape[0])


@dataclass
class EnvMap:
    """One environment map (one per infinite light; its radiance tint is the
    light's row in params['light_L'])."""

    image: jnp.ndarray  # (H, W, 3)
    dist: Distribution2D


class LightSample(NamedTuple):
    wi: jnp.ndarray  # (N,3) unit
    li: jnp.ndarray  # (N,3)
    pdf: jnp.ndarray  # (N,)
    present: jnp.ndarray  # (N,) bool — reference's Option<Spectrum>
    # shadow ray (o, d, t_max):
    vis_o: jnp.ndarray
    vis_d: jnp.ndarray
    vis_tmax: jnp.ndarray


def empty_lights() -> LightArrays:
    # host numpy, like the compiler's LightArrays (the table is a static
    # jit constant; mixing jnp/np conventions invites traced-indexing bugs)
    z3 = np.zeros((0, 3), np.float32)
    return LightArrays(
        type_id=np.zeros((0,), np.int32),
        is_delta=np.zeros((0,), bool),
        vec=z3, tri_p0=z3, tri_p1=z3, tri_p2=z3,
        sph_o2w=np.zeros((0, 4, 4), np.float32), sph_w2o=np.zeros((0, 4, 4), np.float32),
        sph_radius=np.zeros((0,), np.float32), area=np.zeros((0,), np.float32),
        env_id=np.full((0,), -1, np.int32),
    )


def build_env_distribution(image: np.ndarray) -> Distribution2D:
    """Luminance·sin θ importance table (infinite_area.rs:10-26)."""
    h = image.shape[0]
    lum = 0.212671 * image[..., 0] + 0.715160 * image[..., 1] + 0.072169 * image[..., 2]
    theta = (np.arange(h, dtype=np.float64) + 0.5) / h * np.pi
    f = lum * np.sin(theta)[:, None]
    return build_distribution_2d(f)


# ---------------------------------------------------------------------------
# batched light ops. `light_idx`: (N,) i32 chosen light per ray.


def _gather(arr, idx):
    return m.take_small(arr, idx)


def types_present(lights: LightArrays):
    """Static set of light types in the table (lights arrays are concrete
    at trace time — they're scene constants, not traced args), used to skip
    entire per-type branches and their (N,…) gathers."""
    try:
        return frozenset(int(t) for t in np.asarray(lights.type_id))
    except Exception:  # traced (shouldn't happen) — keep all branches
        return frozenset({TYPE_POINT, TYPE_DISTANT, TYPE_AREA_TRI,
                          TYPE_AREA_SPH, TYPE_INFINITE})


def sample_li(
    lights: LightArrays,
    envs,  # sequence of EnvMap (one per infinite light, indexed by env_id)
    light_L,  # (L,3) from params
    light_idx,  # (N,)
    p, n, p_err,  # surface shape point (N,3) each
    u2,  # (N,2)
) -> LightSample:
    """Vectorized Light::sample_li over per-ray chosen lights."""
    N = p.shape[0]
    tp = types_present(lights)
    t = _gather(lights.type_id, light_idx)
    L = _gather(light_L, light_idx)  # (N,3)

    wi = jnp.zeros((N, 3), Float)
    li = jnp.zeros((N, 3), Float)
    pdf = jnp.zeros((N,), Float)
    present = jnp.zeros((N,), bool)
    # target shape point for two-point visibility rays
    to_p = jnp.zeros((N, 3), Float)
    to_n = jnp.zeros((N, 3), Float)
    to_err = jnp.zeros((N, 3), Float)
    unbounded = jnp.zeros((N,), bool)  # distant/infinite use o+d rays

    # ---- POINT (I/r²; delta)
    if TYPE_POINT in tp:
        lp = _gather(lights.vec, light_idx)
        d = lp - p
        d2 = m.length_sq(d)
        sel = t == TYPE_POINT
        wi_pt = m.normalize(d)
        li_pt = L / jnp.maximum(d2, 1e-20)[:, None]
        wi = jnp.where(sel[:, None], wi_pt, wi)
        li = jnp.where(sel[:, None], li_pt, li)
        pdf = jnp.where(sel, 1.0, pdf)
        present = jnp.where(sel, True, present)
        to_p = jnp.where(sel[:, None], lp, to_p)
        to_n = jnp.where(sel[:, None], -wi_pt, to_n)  # normal unused (err=0)

    # ---- DISTANT (delta, unbounded visibility ray)
    if TYPE_DISTANT in tp:
        sel = t == TYPE_DISTANT
        w = _gather(lights.vec, light_idx)
        wi = jnp.where(sel[:, None], -w, wi)
        li = jnp.where(sel[:, None], L, li)
        pdf = jnp.where(sel, 1.0, pdf)
        present = jnp.where(sel, True, present)
        unbounded = unbounded | sel

    # ---- AREA_TRI: uniform area sample → solid-angle pdf
    if TYPE_AREA_TRI in tp:
        sel = t == TYPE_AREA_TRI
        p0 = _gather(lights.tri_p0, light_idx)
        p1 = _gather(lights.tri_p1, light_idx)
        p2 = _gather(lights.tri_p2, light_idx)
        b = m.uniform_sample_triangle(u2)
        b0, b1 = b[:, 0:1], b[:, 1:2]
        b2 = 1.0 - b0 - b1
        sp_p = b0 * p0 + b1 * p1 + b2 * p2
        sp_n = m.normalize(m.cross(p0 - p2, p1 - p2))
        sp_err = _G6 * (jnp.abs(b0 * p0) + jnp.abs(b1 * p1) + jnp.abs(b2 * p2))
        area = _gather(lights.area, light_idx)
        wvec = sp_p - p
        dist2 = m.length_sq(wvec)
        # default_sample_by_point (shape/mod.rs:24-41): pdf_area·dist²/(-ŵ·n), no
        # abs — replicated exactly; NaN/inf → 0
        denom = -m.dot(m.normalize(wvec), sp_n)
        pdf_tri = (1.0 / jnp.maximum(area, 1e-20)) * dist2 / jnp.where(denom == 0, 1.0, denom)
        bad = (denom == 0) | (dist2 == 0) | jnp.isnan(pdf_tri) | jnp.isinf(pdf_tri)
        pdf_tri = jnp.where(bad, 0.0, pdf_tri)
        wi_tri = m.normalize(wvec)
        wi = jnp.where(sel[:, None], wi_tri, wi)
        li = jnp.where(sel[:, None], L, li)  # two-sided constant (area.rs:21-23)
        pdf = jnp.where(sel, pdf_tri, pdf)
        present = jnp.where(sel, dist2 > 0, present)
        to_p = jnp.where(sel[:, None], sp_p, to_p)
        to_n = jnp.where(sel[:, None], sp_n, to_n)
        to_err = jnp.where(sel[:, None], sp_err, to_err)

    # ---- AREA_SPH: cone sampling from outside (sphere.rs:66-95), uniform
    # sphere + reprojection inside
    if TYPE_AREA_SPH in tp:
        sel = t == TYPE_AREA_SPH
        w2o = _gather(lights.sph_w2o, light_idx)
        o2w = _gather(lights.sph_o2w, light_idx)
        radius = _gather(lights.sph_radius, light_idx)
        p_obj = jnp.einsum("nij,nj->ni", w2o[:, :3, :3], p) + w2o[:, :3, 3]
        dist2_o = m.length_sq(p_obj)
        r2 = radius * radius
        outside = dist2_o > r2

        # outside: cone sample
        dist = jnp.sqrt(jnp.maximum(dist2_o, 1e-20))
        z_ax = p_obj / dist[:, None]
        x_ax, y_ax = m.coordinate_system(z_ax)
        sin2_max = r2 / jnp.maximum(dist2_o, 1e-20)
        cos_max = safe_sqrt(1.0 - sin2_max)
        cos_t = (1.0 - u2[:, 0]) + u2[:, 0] * cos_max
        sin_t = safe_sqrt(1.0 - cos_t * cos_t)
        phi = u2[:, 1] * 2.0 * np.pi
        ds = dist * cos_t - safe_sqrt(r2 - dist2_o * sin_t * sin_t)
        cos_a = (dist2_o + r2 - ds * ds) / (2.0 * dist * jnp.maximum(radius, 1e-20))
        sin_a = safe_sqrt(1.0 - cos_a * cos_a)
        dvec = (
            cos_a[:, None] * z_ax
            + (sin_a * jnp.cos(phi))[:, None] * x_ax
            + (sin_a * jnp.sin(phi))[:, None] * y_ax
        )
        sp_obj_out = dvec * radius[:, None]
        n_obj_out = dvec
        pdf_out = 1.0 / (2.0 * np.pi * jnp.maximum(1.0 - cos_max, 1e-12))

        # inside: uniform full-sphere area sample, solid-angle reprojection
        d_in = m.uniform_sample_hemisphere(u2)  # full sphere (see ops.math)
        sp_obj_in = d_in * radius[:, None]
        n_obj_in = d_in
        wvec_o = sp_obj_in - p_obj
        denom_in = -m.dot(m.normalize(wvec_o), n_obj_in)
        pdf_in = (
            (1.0 / jnp.maximum(4.0 * np.pi * r2, 1e-20))
            * m.length_sq(wvec_o)
            / jnp.where(denom_in == 0, 1.0, denom_in)
        )
        pdf_in = jnp.where(
            (denom_in == 0) | jnp.isnan(pdf_in) | jnp.isinf(pdf_in), 0.0, pdf_in
        )

        sp_obj = jnp.where(outside[:, None], sp_obj_out, sp_obj_in)
        n_obj = jnp.where(outside[:, None], n_obj_out, n_obj_in)
        pdf_sph = jnp.where(outside, pdf_out, pdf_in)
        sp_w, sn_w, serr_w = transform_shape_point(o2w, w2o, sp_obj, n_obj)
        wvec = sp_w - p
        dist2w = m.length_sq(wvec)
        wi_sph = m.normalize(wvec)
        ok_sph = (dist2w > 0) & (pdf_sph != 0)
        wi = jnp.where(sel[:, None], wi_sph, wi)
        li = jnp.where(sel[:, None], L, li)
        pdf = jnp.where(sel, pdf_sph, pdf)
        present = jnp.where(sel, ok_sph, present)
        to_p = jnp.where(sel[:, None], sp_w, to_p)
        to_n = jnp.where(sel[:, None], sn_w, to_n)
        to_err = jnp.where(sel[:, None], serr_w, to_err)

    # ---- INFINITE: env importance sample. Each infinite light samples its
    # OWN map's 2-D table — lanes select their map by the chosen light's
    # env_id (a second importance table is a handful of extra VPU ops only
    # in multi-env scenes; single-env scenes run exactly one iteration).
    if envs and TYPE_INFINITE in tp:
        eids = _gather(jnp.asarray(lights.env_id), light_idx)
        for eid, env in enumerate(envs):
            sel = (t == TYPE_INFINITE) & (eids == eid)
            uv, density = sample_2d_continuous(env.dist, u2)
            # rows=θ, cols=φ (consistent mapping; see module docstring)
            theta_n, phi_n = uv[:, 0], uv[:, 1]
            wi_env = m.normalized_phi_theta_to_spherical(
                jnp.stack([phi_n, theta_n], axis=-1)
            )
            sin_theta = jnp.sin(theta_n * np.pi)
            pdf_env = jnp.where(
                sin_theta != 0, density / (2.0 * np.pi * np.pi * sin_theta), 0.0
            )
            li_env = eval_env(env, wi_env) * L
            wi = jnp.where(sel[:, None], wi_env, wi)
            li = jnp.where(sel[:, None], li_env, li)
            pdf = jnp.where(sel, pdf_env, pdf)
            present = jnp.where(sel, True, present)
            unbounded = unbounded | sel

    # ---- visibility rays
    # bounded: two-point ray with both endpoints offset (VisibilityTester::new)
    o_b = offset_point_by_error(p, n, p_err, to_p - p)
    to_b = offset_point_by_error(to_p, to_n, to_err, o_b - to_p)
    d_b = to_b - o_b
    t_b = jnp.full((N,), Float(1.0 - 1e-5))
    # unbounded: origin-offset directional ray (VisibilityTester::new_od)
    o_u = offset_point_by_error(p, n, p_err, wi)
    vis_o = jnp.where(unbounded[:, None], o_u, o_b)
    vis_d = jnp.where(unbounded[:, None], wi, d_b)
    vis_t = jnp.where(unbounded, FLOAT_MAX, t_b)

    return LightSample(wi, li, pdf, present, vis_o, vis_d, vis_t)


def eval_env(env: EnvMap, w):
    """Escaped-ray radiance lookup (infinite_area.rs:35-39 + the image
    evaluate v-flip pair, which nets to row=θ, col=φ)."""
    uv = m.spherical_to_normalized_phi_theta(m.normalize(w))
    img = jnp.asarray(env.image)  # env.image is host numpy (a jit constant)
    h, wd = img.shape[0], img.shape[1]
    y = jnp.clip((uv[..., 1] * h).astype(jnp.int32), 0, h - 1)
    x = jnp.clip((uv[..., 0] * wd).astype(jnp.int32), 0, wd - 1)
    return img[y, x]


def env_out_scene_pdf(env: EnvMap, w):
    """out_scene_pdf (infinite_area.rs:40-52), consistent mapping."""
    uv = m.spherical_to_normalized_phi_theta(m.normalize(w))
    density = pdf_2d_continuous(env.dist, jnp.stack([uv[..., 1], uv[..., 0]], axis=-1))
    sin_theta = jnp.sin(uv[..., 1] * np.pi)
    return jnp.where(sin_theta != 0, density / (2.0 * np.pi * np.pi * sin_theta), 0.0)


def le_out_scene_total(lights: LightArrays, envs, light_L, d):
    """Σ over lights of le_out_scene(ray) — only infinite lights contribute
    (path.rs:24-28), each through its own map. d: (N,3) → (N,3)."""
    out = jnp.zeros(d.shape[:-1] + (3,), Float)
    for eid, env in enumerate(envs or ()):
        is_mine = (lights.type_id == TYPE_INFINITE) & (lights.env_id == eid)
        tint = jnp.sum(jnp.where(is_mine[:, None], light_L, 0.0), axis=0)
        out = out + eval_env(env, d) * tint[None, :]
    return out


def le_emitted(light_L, light_idx):
    """Surface emission of a hit area-light primitive — two-sided constant L
    (area.rs:21-23). light_idx: (N,) (−1 → none)."""
    safe = jnp.maximum(light_idx, 0)
    L = m.take_small(light_L, safe)
    return jnp.where((light_idx >= 0)[:, None], L, 0.0)


def le_pdf(lights: LightArrays, light_idx, ref_p, hit_p, hit_n=None):
    """Light::pdf → Shape::by_point_pdf for area lights: solid-angle density
    of sampling the direction that produced this hit.

    tri: default_by_point_pdf (shape/mod.rs:42-52, WITH abs in denominator);
    sphere: cone pdf outside (sphere.rs:96-105), default inside.

    hit_n may be None: only the triangle branch needs a surface normal and
    the light's OWN geometry supplies it, letting the caller use a slim
    (t, prim)-only intersect for the MIS leg.
    """
    N = ref_p.shape[0]
    tp = types_present(lights)
    t = _gather(lights.type_id, jnp.maximum(light_idx, 0))
    pdf = jnp.zeros((N,), Float)

    # triangle default pdf
    if TYPE_AREA_TRI in tp:
        sel = t == TYPE_AREA_TRI
        area = _gather(lights.area, jnp.maximum(light_idx, 0))
        if hit_n is None:
            tp0 = _gather(lights.tri_p0, jnp.maximum(light_idx, 0))
            tp1 = _gather(lights.tri_p1, jnp.maximum(light_idx, 0))
            tp2 = _gather(lights.tri_p2, jnp.maximum(light_idx, 0))
            hit_n = m.normalize(m.cross(tp0 - tp2, tp1 - tp2))
        dvec = ref_p - hit_p
        dist2 = m.length_sq(dvec)
        dist = jnp.sqrt(jnp.maximum(dist2, 1e-20))
        denom = jnp.abs(m.dot(dvec / dist[:, None], hit_n)) * area
        pdf_tri = dist2 / jnp.where(denom == 0, 1.0, denom)
        pdf_tri = jnp.where(
            (denom == 0) | jnp.isnan(pdf_tri) | jnp.isinf(pdf_tri), 0.0, pdf_tri
        )
        pdf = jnp.where(sel, pdf_tri, pdf)

    # sphere
    if TYPE_AREA_SPH in tp:
        sel = t == TYPE_AREA_SPH
        w2o = _gather(lights.sph_w2o, jnp.maximum(light_idx, 0))
        radius = _gather(lights.sph_radius, jnp.maximum(light_idx, 0))
        p_obj = jnp.einsum("nij,nj->ni", w2o[:, :3, :3], ref_p) + w2o[:, :3, 3]
        dist2_o = m.length_sq(p_obj)
        r2 = radius * radius
        outside = dist2_o >= r2
        sin2_max = r2 / jnp.maximum(dist2_o, 1e-20)
        cos_max = safe_sqrt(1.0 - sin2_max)
        pdf_cone = 1.0 / (2.0 * np.pi * jnp.maximum(1.0 - cos_max, 1e-12))
        # inside: default pdf with object-space area
        area_s = 4.0 * np.pi * r2
        hp_obj = jnp.einsum("nij,nj->ni", w2o[:, :3, :3], hit_p) + w2o[:, :3, 3]
        dvec_o = p_obj - hp_obj
        dist2_i = m.length_sq(dvec_o)
        dist_i = jnp.sqrt(jnp.maximum(dist2_i, 1e-20))
        n_obj = m.normalize(hp_obj)
        denom_i = jnp.abs(m.dot(dvec_o / dist_i[:, None], n_obj)) * area_s
        pdf_in = dist2_i / jnp.where(denom_i == 0, 1.0, denom_i)
        pdf_in = jnp.where((denom_i == 0) | jnp.isnan(pdf_in) | jnp.isinf(pdf_in), 0.0, pdf_in)
        pdf_sph = jnp.where(outside, pdf_cone, pdf_in)
        pdf = jnp.where(sel, pdf_sph, pdf)

    return jnp.where(light_idx >= 0, pdf, 0.0)
