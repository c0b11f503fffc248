"""Batched ray–primitive intersection.

SoA geometry tables + dense ray×primitive tests. This is the oracle
intersector and also the fastest path for the smallest scenes: a dense
(N rays × P prims) test is pure elementwise math with zero gathers, while the
reference walks a recursive BVH per ray on CPU
(/root/reference/src/aggregate/bvh.rs:151-190). Large scenes use ops/bvh.py.

Triangle test: watertight Möller (translate–permute–shear, edge functions,
conservative error rejection) exactly as the reference's
geometry/shape/triangle.rs:194-262 (pbrt §3.9), vectorized over (ray, tri)
pairs. Sphere test: object-space quadratic solved with the numerically
stable perpendicular-decomposition form (the reference solves in f64 —
sphere.rs:111-132; devices have no fast f64, the stable form avoids the
cancellation instead).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from curry_pbrt_tpu.dtypes import FLOAT_MAX, Float, gamma
from curry_pbrt_tpu.ops.math import cross, dot, length, normalize, take_small

_G2 = gamma(2)
_G3 = gamma(3)
_G5 = gamma(5)
_G6 = gamma(6)
_G7 = gamma(7)


class TriangleArrays(NamedTuple):
    """World-space triangle soup (transforms baked by the scene compiler).

    p0/p1/p2: (T, 3) f32; prim: (T,) i32 primitive id, -1 for padding.
    """

    p0: jnp.ndarray
    p1: jnp.ndarray
    p2: jnp.ndarray
    prim: jnp.ndarray

    @property
    def count(self) -> int:
        return self.p0.shape[0]


class SphereArrays(NamedTuple):
    """Spheres with per-sphere object spaces (general transforms supported,
    like the reference's TransformShape wrapper — shape/transform.rs).

    o2w/w2o: (S, 4, 4); radius: (S,); prim: (S,) i32 (-1 padding).
    """

    o2w: jnp.ndarray
    w2o: jnp.ndarray
    radius: jnp.ndarray
    prim: jnp.ndarray

    @property
    def count(self) -> int:
        return self.o2w.shape[0]


class Hit(NamedTuple):
    """Per-ray hit record (miss ⇔ prim < 0)."""

    t: jnp.ndarray  # (N,)
    prim: jnp.ndarray  # (N,) i32
    p: jnp.ndarray  # (N, 3)
    n: jnp.ndarray  # (N, 3) geometric normal (unit)
    uv: jnp.ndarray  # (N, 2)
    p_error: jnp.ndarray  # (N, 3) conservative fp bound on p

    @property
    def valid(self):
        return self.prim >= 0


def empty_triangles() -> TriangleArrays:
    z = jnp.zeros((0, 3), Float)
    return TriangleArrays(z, z, z, jnp.zeros((0,), jnp.int32))


def empty_spheres() -> SphereArrays:
    m = jnp.zeros((0, 4, 4), Float)
    return SphereArrays(m, m, jnp.zeros((0,), Float), jnp.zeros((0,), jnp.int32))


# ---------------------------------------------------------------------------
# watertight triangle test


def _argmax3(ad):
    """First-max index over the last (size-3) axis, via compares — a gather
    of axis size 3 across millions of lanes lowers to per-element dynamic
    indexing (far slower than these selects)."""
    ax, ay, az = ad[..., 0], ad[..., 1], ad[..., 2]
    return jnp.where(
        (ax >= ay) & (ax >= az),
        jnp.int32(0),
        jnp.where(ay >= az, jnp.int32(1), jnp.int32(2)),
    )


def _select_by_kz(kz, a, b, c):
    return jnp.where(kz == 0, a, jnp.where(kz == 1, b, c))


def permute_by_kz(v, kz):
    """Return components (v[kx], v[ky], v[kz]) with kx=(kz+1)%3,
    ky=(kz+2)%3 — the watertight test's axis permutation
    (triangle.rs:199-205), computed with 3-way selects instead of gathers.
    v: (...,3); kz: broadcastable (...) i32."""
    v0, v1, v2 = v[..., 0], v[..., 1], v[..., 2]
    return (
        _select_by_kz(kz, v1, v2, v0),
        _select_by_kz(kz, v2, v0, v1),
        _select_by_kz(kz, v0, v1, v2),
    )


def watertight_core(o, kz, sx, sy, sz, t_max, p0, p1, p2, with_bary: bool = True):
    """Watertight Möller test on broadcast-compatible batches.

    o: (..., 3) ray origins; kz: (...) i32 dominant ray axis (from
    `ray_shear`); sx/sy/sz: (...) shear factors; t_max: (...);
    p0/p1/p2: (..., 3) triangle vertices (broadcast against the ray dims).
    Returns (t, b: (...,3) barycentrics — None when with_bary=False — , ok).
    """
    def prep(v):
        return permute_by_kz(v - o, kz)

    p0t, p1t, p2t = prep(p0), prep(p1), prep(p2)

    def shear_xy(p):
        return p[0] + sx * p[2], p[1] + sy * p[2]

    x0, y0 = shear_xy(p0t)
    x1, y1 = shear_xy(p1t)
    x2, y2 = shear_xy(p2t)
    e0 = x1 * y2 - y1 * x2
    e1 = x2 * y0 - y2 * x0
    e2 = x0 * y1 - y0 * x1
    same_side = ~(((e0 < 0) | (e1 < 0) | (e2 < 0)) & ((e0 > 0) | (e1 > 0) | (e2 > 0)))
    det = e0 + e1 + e2
    z0 = p0t[2] * sz
    z1 = p1t[2] * sz
    z2 = p2t[2] * sz
    t_scaled = e0 * z0 + e1 * z1 + e2 * z2
    in_range = jnp.where(
        det < 0,
        (t_scaled < 0) & (t_scaled >= t_max * det),
        (t_scaled > 0) & (t_scaled <= t_max * det),
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
        3.0 * (_G3 * max_e * max_zt + delta_e * max_zt + delta_z * max_e) * jnp.abs(inv_det)
    )

    ok = same_side & (det != 0) & in_range & (t > delta_t)
    b = (
        jnp.stack([e0 * inv_det, e1 * inv_det, e2 * inv_det], axis=-1)
        if with_bary
        else None
    )
    return jnp.where(ok, t, FLOAT_MAX), b, ok


def ray_shear(d):
    """Precompute (kz, sx, sy, sz) for the watertight test. d: (N,3)."""
    kz = _argmax3(jnp.abs(d))
    dx, dy, dz = permute_by_kz(d, kz)
    dz = jnp.where(dz == 0, 1.0, dz)  # degenerate (masked) lanes only
    return kz, -dx / dz, -dy / dz, 1.0 / dz


def triangle_intersect_t(o, d, t_max, tris: TriangleArrays, with_bary: bool = True):
    """Dense (N rays × T tris) watertight test.

    o/d: (N,3); t_max: (N,). Returns t: (N,T), b: (N,T,3), ok: (N,T) bool.
    With with_bary=False, b is None: the (N,T,3) barycentric tensor gets its
    minor dim padded 3→128 lanes by XLA (a ~42× HBM blowup — measured as the
    dominant cost of the old dense pass); callers recompute barycentrics for
    each ray's WINNING triangle only (`triangle_winner_attributes`).
    """
    kz, sx, sy, sz = ray_shear(d)
    t, b, ok = watertight_core(
        o[:, None, :], kz[:, None], sx[:, None], sy[:, None], sz[:, None],
        t_max[:, None], tris.p0[None], tris.p1[None], tris.p2[None],
        with_bary=with_bary,
    )
    ok = ok & (tris.prim[None, :] >= 0)
    return jnp.where(ok, t, FLOAT_MAX), b, ok


def triangle_winner_attributes(o, d, t_max, tri_idx, tris: TriangleArrays):
    """Recompute the watertight test for each ray's WINNING triangle —
    O(N) instead of O(N·T·3) — and derive (p, n, uv, p_error) from the same
    single vertex gather (each per-lane gather from a large table is
    costly, so gathering the vertex tables once matters).

    Default uv chart is (0,0),(1,0),(1,1) — the reference's parsers never
    populate uvs (triangle.rs:69-77). p_error is the γ₇ barycentric bound
    (triangle.rs:259-261)."""
    p0 = take_small(tris.p0, tri_idx)
    p1 = take_small(tris.p1, tri_idx)
    p2 = take_small(tris.p2, tri_idx)
    kz, sx, sy, sz = ray_shear(d)
    _t, b, _ok = watertight_core(o, kz, sx, sy, sz, t_max, p0, p1, p2)
    b0, b1, b2 = b[:, 0:1], b[:, 1:2], b[:, 2:3]
    p = b0 * p0 + b1 * p1 + b2 * p2
    n = normalize(cross(p0 - p2, p1 - p2))
    uv = jnp.concatenate([b[:, 1:2] + b[:, 2:3], b[:, 2:3]], axis=-1)
    p_error = _G7 * (jnp.abs(b0 * p0) + jnp.abs(b1 * p1) + jnp.abs(b2 * p2))
    return p, n, uv, p_error


# ---------------------------------------------------------------------------
# sphere test


def _to_object(sph: SphereArrays, o, d):
    """Transform rays into every sphere's object space.

    o/d: (N,3) → o_obj/d_obj: (N,S,3).
    """
    r = sph.w2o[:, :3, :3]  # (S,3,3)
    t = sph.w2o[:, :3, 3]  # (S,3)
    o_obj = jnp.einsum("sij,nj->nsi", r, o) + t[None, :, :]
    d_obj = jnp.einsum("sij,nj->nsi", r, d)
    return o_obj, d_obj


def sphere_quadratic(o_obj, d_obj, radius, t_max):
    """Solve |o + t d|² = r² with the reference's stable q-form
    (sphere.rs:111-132 does this in f64; here the small root is recovered as
    c/q so a ray spawned just OUTSIDE the sphere — c > 0 — can never produce
    a spurious non-negative exit root, which division/rsqrt rounding
    otherwise causes; the discriminant uses the geometric perpendicular
    distance, stable for grazing rays).

    All args broadcastable; returns (t, ok) with the reference's root pick
    (t0 if ≥ 0 else t1) and range tests.
    """
    a = jnp.sum(d_obj * d_obj, axis=-1)
    safe_a = jnp.where(a == 0, 1.0, a)
    b_half = jnp.sum(o_obj * d_obj, axis=-1)
    c = jnp.sum(o_obj * o_obj, axis=-1) - radius * radius
    t_center = -b_half / safe_a
    perp = o_obj + t_center[..., None] * d_obj
    perp2 = jnp.sum(perp * perp, axis=-1)
    r2 = radius * radius
    disc_ok = (perp2 <= r2) & (a > 0)
    from curry_pbrt_tpu.ops.math import safe_sqrt as _ss
    s = _ss(a * (r2 - perp2))
    sgn = jnp.where(b_half >= 0, 1.0, -1.0)
    q = -(b_half + sgn * s)
    safe_q = jnp.where(q == 0, 1.0, q)
    r1 = q / safe_a
    r2_ = jnp.where(q == 0, r1, c / safe_q)
    t0 = jnp.minimum(r1, r2_)
    t1 = jnp.maximum(r1, r2_)
    # reference accepts t0 if ≥0 else t1, rejects t0>t_max or t1<0
    t = jnp.where(t0 >= 0.0, t0, t1)
    ok = disc_ok & (t0 <= t_max) & (t1 >= 0.0) & (t <= t_max)
    return jnp.where(ok, t, FLOAT_MAX), ok


def sphere_intersect_t(o, d, t_max, sph: SphereArrays):
    """Dense (N × S) sphere test → (t: (N,S), ok: (N,S))."""
    o_obj, d_obj = _to_object(sph, o, d)
    t, ok = sphere_quadratic(o_obj, d_obj, sph.radius[None, :], t_max[:, None])
    ok = ok & (sph.prim[None, :] >= 0)
    return jnp.where(ok, t, FLOAT_MAX), ok


def sphere_hit_attributes(sph_idx, t, o, d, sph: SphereArrays):
    """Hit attributes for per-ray winning spheres (object-space reproject +
    γ₅ error, uv from spherical — sphere.rs:14-18,41-52 — then transformed
    to world with the ShapePoint error bound, shape/mod.rs:135-160)."""
    w2o = take_small(sph.w2o, sph_idx)  # (N,4,4)
    o2w = take_small(sph.o2w, sph_idx)
    radius = take_small(sph.radius, sph_idx)
    o_obj = jnp.einsum("nij,nj->ni", w2o[:, :3, :3], o) + w2o[:, :3, 3]
    d_obj = jnp.einsum("nij,nj->ni", w2o[:, :3, :3], d)
    p_obj = o_obj + t[:, None] * d_obj
    p_obj = p_obj * (radius / jnp.maximum(length(p_obj), 1e-30))[:, None]
    n_obj = normalize(p_obj)
    uv = sphere_uv(p_obj, radius)
    p_err_obj = _G5 * jnp.abs(p_obj)
    p, n, p_error = transform_shape_point(o2w, w2o, p_obj, n_obj)
    del p_err_obj  # reference recomputes the bound after transforming
    return p, n, uv, p_error


def sphere_uv(p_obj, radius):
    u = (jnp.arctan2(p_obj[..., 1], p_obj[..., 0]) + np.pi) * Float(0.5 / np.pi)
    v = jnp.arccos(jnp.clip(p_obj[..., 2] / radius, -1.0, 1.0)) * Float(1.0 / np.pi)
    return jnp.stack([u, v], axis=-1)


def transform_shape_point(o2w, w2o, p_obj, n_obj):
    """Transform an object-space surface point + normal to world.

    Normal via inverse-transpose (normal.rs:32-37, renormalized); the point
    error bound is γ₃ · |M|·|p| per row as in ShapePoint::apply
    (shape/mod.rs:135-160).
    o2w/w2o: (N,4,4) or (4,4); p_obj/n_obj: (N,3).
    """
    if o2w.ndim == 2:
        o2w = jnp.broadcast_to(o2w, (p_obj.shape[0], 4, 4))
        w2o = jnp.broadcast_to(w2o, (p_obj.shape[0], 4, 4))
    p = jnp.einsum("nij,nj->ni", o2w[:, :3, :3], p_obj) + o2w[:, :3, 3]
    n = normalize(jnp.einsum("nji,nj->ni", w2o[:, :3, :3], n_obj))
    abs_m = jnp.abs(o2w[:, :3, :3])
    p_error = _G3 * (
        jnp.einsum("nij,nj->ni", abs_m, jnp.abs(p_obj)) + jnp.abs(o2w[:, :3, 3])
    )
    return p, n, p_error


# ---------------------------------------------------------------------------
# error-offset ray spawning — reference shape/mod.rs:119-126, ray.rs:27-36


def offset_point_by_error(p, n, p_error, w):
    """Offset p along ±n by the error bound, sign chosen toward w."""
    d = dot(jnp.abs(n), p_error)
    offset = n * d[..., None]
    flip = (dot(w, n) < 0.0)[..., None]
    return p + jnp.where(flip, -offset, offset)


def spawn_ray(p, n, p_error, d):
    """Continuation ray from a surface point (Ray::new_shape_point_d)."""
    return offset_point_by_error(p, n, p_error, d), d


def shadow_ray_between(p_a, n_a, err_a, p_b, n_b, err_b):
    """Two-point shadow ray: offset both endpoints, t_max = 1−1e-5
    (VisibilityTester::new — light/mod.rs:101-110)."""
    o = offset_point_by_error(p_a, n_a, err_a, p_b - p_a)
    to = offset_point_by_error(p_b, n_b, err_b, o - p_b)
    d = to - o
    t_max = jnp.full(p_a.shape[:-1], Float(1.0 - 1e-5))
    return o, d, t_max


# ---------------------------------------------------------------------------
# brute-force aggregate


def intersect_brute(
    o, d, t_max, tris: TriangleArrays, sph: SphereArrays, tri_prim_mask=None
) -> Hit:
    """Closest-hit over all primitives (dense). o/d: (N,3), t_max: (N,)."""
    n_rays = o.shape[0]
    best_t = jnp.broadcast_to(jnp.asarray(FLOAT_MAX), (n_rays,))
    hit_prim = jnp.full((n_rays,), -1, jnp.int32)

    have_tris = tris.count > 0
    have_sph = sph.count > 0

    if have_tris:
        tt, _, tok = triangle_intersect_t(o, d, t_max, tris, with_bary=False)
        tri_best = jnp.argmin(tt, axis=-1).astype(jnp.int32)
        # winner extraction via one-hot reductions (take_along_axis on the
        # minor axis is a per-element gather)
        oh_t = jnp.arange(tt.shape[1], dtype=jnp.int32)[None, :] == tri_best[:, None]
        tri_t = jnp.min(tt, axis=-1)
        tri_hit = jnp.any(tok & oh_t, axis=-1)
    if have_sph:
        st, sok = sphere_intersect_t(o, d, t_max, sph)
        sph_best = jnp.argmin(st, axis=-1).astype(jnp.int32)
        oh_s = jnp.arange(st.shape[1], dtype=jnp.int32)[None, :] == sph_best[:, None]
        sph_t = jnp.min(st, axis=-1)
        sph_hit = jnp.any(sok & oh_s, axis=-1)

    p = jnp.zeros((n_rays, 3), Float)
    n = jnp.zeros((n_rays, 3), Float)
    uv = jnp.zeros((n_rays, 2), Float)
    p_error = jnp.zeros((n_rays, 3), Float)
    t_out = best_t

    if have_tris and have_sph:
        use_tri = tri_hit & (~sph_hit | (tri_t <= sph_t))
        use_sph = sph_hit & ~use_tri
    elif have_tris:
        use_tri = tri_hit
        use_sph = None
    elif have_sph:
        use_tri = None
        use_sph = sph_hit
    else:
        return Hit(t_out, hit_prim, p, n, uv, p_error)

    if have_tris:
        tp, tn, tuv, terr = triangle_winner_attributes(o, d, t_max, tri_best, tris)
        m = use_tri[:, None]
        p = jnp.where(m, tp, p)
        n = jnp.where(m, tn, n)
        uv = jnp.where(use_tri[:, None], tuv, uv)
        p_error = jnp.where(m, terr, p_error)
        t_out = jnp.where(use_tri, tri_t, t_out)
        hit_prim = jnp.where(use_tri, take_small(tris.prim, tri_best), hit_prim)
    if have_sph:
        sp, sn, suv, serr = sphere_hit_attributes(sph_best, sph_t, o, d, sph)
        m = use_sph[:, None]
        p = jnp.where(m, sp, p)
        n = jnp.where(m, sn, n)
        uv = jnp.where(use_sph[:, None], suv, uv)
        p_error = jnp.where(m, serr, p_error)
        t_out = jnp.where(use_sph, sph_t, t_out)
        hit_prim = jnp.where(use_sph, take_small(sph.prim, sph_best), hit_prim)

    return Hit(t_out, hit_prim, p, n, uv, p_error)


def intersect_tprim_brute(o, d, t_max, tris: TriangleArrays, sph: SphereArrays):
    """Slim closest-hit: (t, prim) only — no attribute reconstruction.
    Used by the NEE MIS leg, which needs just the hit identity and distance
    (the light's own table supplies its geometry)."""
    n_rays = o.shape[0]
    t_out = jnp.broadcast_to(jnp.asarray(FLOAT_MAX), (n_rays,))
    prim = jnp.full((n_rays,), -1, jnp.int32)
    if tris.count > 0:
        tt, _, tok = triangle_intersect_t(o, d, t_max, tris, with_bary=False)
        tri_best = jnp.argmin(tt, axis=-1).astype(jnp.int32)
        oh = jnp.arange(tt.shape[1], dtype=jnp.int32)[None, :] == tri_best[:, None]
        tri_t = jnp.min(tt, axis=-1)
        tri_hit = jnp.any(tok & oh, axis=-1)
        t_out = jnp.where(tri_hit, tri_t, t_out)
        prim = jnp.where(tri_hit, take_small(tris.prim, tri_best), prim)
    if sph.count > 0:
        st, sok = sphere_intersect_t(o, d, t_max, sph)
        sph_best = jnp.argmin(st, axis=-1).astype(jnp.int32)
        oh = jnp.arange(st.shape[1], dtype=jnp.int32)[None, :] == sph_best[:, None]
        sph_t = jnp.min(st, axis=-1)
        sph_hit = jnp.any(sok & oh, axis=-1)
        use = sph_hit & (sph_t < t_out)
        t_out = jnp.where(use, sph_t, t_out)
        prim = jnp.where(use, take_small(sph.prim, sph_best), prim)
    return t_out, prim


def intersect_predicate_brute(o, d, t_max, tris: TriangleArrays, sph: SphereArrays):
    """Any-hit test (shadow rays). Returns (N,) bool."""
    hit = jnp.zeros(o.shape[:1], bool)
    if tris.count > 0:
        _, _, tok = triangle_intersect_t(o, d, t_max, tris, with_bary=False)
        hit = hit | jnp.any(tok, axis=-1)
    if sph.count > 0:
        _, sok = sphere_intersect_t(o, d, t_max, sph)
        hit = hit | jnp.any(sok, axis=-1)
    return hit
