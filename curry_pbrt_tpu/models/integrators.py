"""Wavefront integrators: MIS-NEE path tracing and direct lighting.

The reference traces one ray at a time through a recursive loop
(/root/reference/src/integrator/path.rs) with dynamic control flow. This
version holds the WHOLE ray batch in SoA arrays and runs a fixed-depth,
fully-unrolled wavefront loop with active-lane masks:

    for bounce in 0..max_depth+1:
        intersect-all → add emission (bounce 0 / specular chains)
        → NEE (pick light, shadow ray, MIS; + bsdf-strategy leg)
        → BSDF sample → spawn continuation → Russian roulette (mask+reweight)

Every lane consumes the same, statically-assigned Halton dimensions per
bounce (8: light pick, light 2D, NEE-bsdf 2D, bsdf bucket+extra, RR), which
keeps the sampler a pure function of (pixel, sample, dim) — the reference's
dim counter advances data-dependently instead (documented in DESIGN.md; our
CPU oracle is this same code on the CPU backend, seeded identically).

Shading dispatches over the scene's (deduplicated) material instances with
lane masks — each instance's lobe list is static so its BSDF math
vectorizes exactly (see models/materials.py).

Algorithm mapping to the reference:
  uniform_sample_one_light ← integrator/mod.rs:13-97 (both MIS strategies,
      delta-light shortcut, Arc::ptr_eq light identity → light-id compare)
  PathIntegrator::li       ← integrator/path.rs:13-66 (emission gating on
      bounce-0/specular, NEE gating on is_all_delta, RR after bounce 3 with
      q = max(0.05, 1−β.y), throughput update β·f·|cosθ|/pdf)
  DirectLightIntegrator    ← integrator/direct_light.rs (NEE at first hit +
      delta recursion; the reference's per-ray branch enumeration becomes a
      luminance-weighted stochastic single branch — see direct_light_trace)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from curry_pbrt_tpu.dtypes import FLOAT_MAX, Float
from curry_pbrt_tpu.models import lights as LT
from curry_pbrt_tpu.models.materials import (
    CompiledMaterial,
    MaterialFamily,
    lobe_kinds,
)
from curry_pbrt_tpu.ops import bsdf as B
from curry_pbrt_tpu.ops import math as m
from curry_pbrt_tpu.ops.halton import HaltonConfig, halton_sample
from curry_pbrt_tpu.ops.intersect import Hit, offset_point_by_error

DIMS_PER_BOUNCE = 8
(D_LIGHT_PICK, D_LIGHT_U, D_LIGHT_V, D_NEE_U, D_NEE_V, D_BSDF_BUCKET,
 D_BSDF_EXTRA, D_RR) = range(DIMS_PER_BOUNCE)


@dataclass
class ShadeContext:
    """Static shading info shared by the integrators."""

    materials: List[CompiledMaterial]  # only instances actually referenced
    families: List[MaterialFamily]  # shading dispatch groups over `materials`
    registry: dict  # named materials (for mix)
    lights: LT.LightArrays
    envs: List[LT.EnvMap]  # one per infinite light (lights.env_id indexes)
    n_lights: int
    mat_is_all_delta: np.ndarray  # host (M_total,) indexed by mat_id
    intersect: Callable  # (o, d, t_max) -> Hit
    predicate: Callable  # (o, d, t_max) -> (N,) bool
    intersect_tprim: Callable  # (o, d, t_max) -> (t, prim) — slim MIS-leg path
    prim_mat: jnp.ndarray  # (P,)
    prim_light: jnp.ndarray  # (P,)

    def mat_mask(self, mat_ids, mat: CompiledMaterial):
        return mat_ids == mat.mat_id


def _shading_frame(n):
    """BSDF::new with sn == n (bxdf/mod.rs:83-97): local +z is the geometric
    normal."""
    x, y = m.coordinate_system(n)
    return x, y, n


def build_family_lobes(ctx: ShadeContext, mat_ids, uv, params):
    """Evaluate every family's lobe stack ONCE for this batch (textures and
    parameter gathers are the expensive part — a shading point is consumed
    by shade_eval + NEE's sample + the continuation sample, and rebuilding
    lobes per call re-gathered every texture 3× per bounce).

    Returns [(family, lobes)], the `fam_lobes` the shade_* functions take.
    """
    return [
        (fam, fam.make_lobes(uv, params, ctx.registry, mat_ids))
        for fam in ctx.families
    ]


def _nondelta_fams(ctx, fam_lobes):
    return [
        (fam, lobes)
        for fam, lobes in fam_lobes
        if not all(k in B.DELTA_KINDS for k in lobe_kinds(fam.rep, ctx.registry))
    ]


def shade_eval(ctx: ShadeContext, fam_lobes, mat_ids, wo_l, wi_l):
    """no_delta_f_pdf across material FAMILIES → (f, pdf, present).

    Each family is one vectorized lobe-stack eval with per-lane gathered
    constants; lanes select their family by material id (the EP-analog
    grouping — SURVEY §2.8)."""
    N = wo_l.shape[0]
    f = jnp.zeros((N, 3), Float)
    pdf = jnp.zeros((N,), Float)
    present = jnp.zeros((N,), bool)
    for fam, lobes in _nondelta_fams(ctx, fam_lobes):
        mf, mp, mpres = B.bsdf_eval_pdf(lobes, wo_l, wi_l)
        sel = fam.mask(mat_ids)
        f = jnp.where(sel[:, None], mf, f)
        pdf = jnp.where(sel, mp, pdf)
        present = jnp.where(sel, mpres, present)
    return f, pdf, present


def shade_sample_nondelta(ctx: ShadeContext, fam_lobes, mat_ids, wo_l, u_pick, u2):
    """sample_no_delta_f across families → (wi_l, f, pdf, present)."""
    N = wo_l.shape[0]
    wi = jnp.zeros((N, 3), Float)
    f = jnp.zeros((N, 3), Float)
    pdf = jnp.zeros((N,), Float)
    present = jnp.zeros((N,), bool)
    for fam, lobes in _nondelta_fams(ctx, fam_lobes):
        mwi, mf, mp, mpres = B.bsdf_sample_nondelta(lobes, wo_l, u_pick, u2)
        sel = fam.mask(mat_ids)
        wi = jnp.where(sel[:, None], mwi, wi)
        f = jnp.where(sel[:, None], mf, f)
        pdf = jnp.where(sel, mp, pdf)
        present = jnp.where(sel, mpres, present)
    return wi, f, pdf, present


def shade_sample(ctx: ShadeContext, fam_lobes, mat_ids, wo_l, u_bucket, u_extra):
    """sample_f across families → (wi_l, f, pdf, present, is_delta)."""
    N = wo_l.shape[0]
    wi = jnp.zeros((N, 3), Float)
    f = jnp.zeros((N, 3), Float)
    pdf = jnp.zeros((N,), Float)
    present = jnp.zeros((N,), bool)
    is_delta = jnp.zeros((N,), bool)
    for fam, lobes in fam_lobes:
        mwi, mf, mp, mpres, mdelta = B.bsdf_sample(lobes, wo_l, u_bucket, u_extra)
        sel = fam.mask(mat_ids)
        wi = jnp.where(sel[:, None], mwi, wi)
        f = jnp.where(sel[:, None], mf, f)
        pdf = jnp.where(sel, mp, pdf)
        present = jnp.where(sel, mpres, present)
        is_delta = jnp.where(sel, mdelta, is_delta)
    return wi, f, pdf, present, is_delta


def uniform_sample_one_light(ctx, params, hit: Hit, mat_ids, wo, frame, u,
                             fam_lobes=None, mask=None):
    """One-light MIS NEE for a shaded batch (integrator/mod.rs:13-97).

    u: dict of sampler values for this bounce. fam_lobes: prebuilt
    build_family_lobes output (built here if None). mask: lanes whose NEE
    result is actually consumed — the shadow/MIS rays of dead lanes get
    t_max 0 so the intersector's box tests cull them instantly (their
    radiance is discarded by the caller either way; this is a wavefront
    throughput optimization, not a semantic change). Returns (N,3) radiance
    (already multiplied by the light count).
    """
    if ctx.n_lights == 0:
        return jnp.zeros(wo.shape, Float)
    N = wo.shape[0]
    fx, fy, fz = frame
    p, n, perr, uv = hit.p, hit.n, hit.p_error, hit.uv
    if fam_lobes is None:
        fam_lobes = build_family_lobes(ctx, mat_ids, uv, params)
    light_L = params["light_L"]

    # pick one light uniformly (get_usize — sampler/mod.rs:26-35)
    lf = u["light_pick"] * Float(ctx.n_lights)
    light_idx = jnp.minimum(lf.astype(jnp.int32), ctx.n_lights - 1)

    ls = LT.sample_li(
        ctx.lights, ctx.envs, light_L, light_idx, p, n, perr,
        jnp.stack([u["light_u"], u["light_v"]], axis=-1),
    )
    chosen_delta = m.take_small(ctx.lights.is_delta, light_idx)

    # --- light strategy
    wi_l = m.to_local(ls.wi, fx, fy, fz)
    wo_l = m.to_local(wo, fx, fy, fz)
    f, f_pdf, f_pres = shade_eval(ctx, fam_lobes, mat_ids, wo_l, wi_l)
    vis_tmax = ls.vis_tmax if mask is None else jnp.where(mask, ls.vis_tmax, 0.0)
    occluded = ctx.predicate(ls.vis_o, ls.vis_d, vis_tmax)
    cos_term = jnp.abs(m.dot(n, ls.wi))
    safe_li_pdf = jnp.where(ls.pdf == 0, 1.0, ls.pdf)
    weight = jnp.where(
        chosen_delta, 1.0, m.power_heuristic(ls.pdf, f_pdf)
    )

    # --- bsdf strategy (non-delta lights only, integrator/mod.rs:54-90)
    wi2_l, f2, f2_pdf, f2_pres = shade_sample_nondelta(
        ctx, fam_lobes, mat_ids, wo_l, u["nee_u"], u["nee_v"]
    )
    wi2 = m.to_world(wi2_l, fx, fy, fz)
    o2 = offset_point_by_error(p, n, perr, wi2)
    # slim intersect: the MIS leg needs only hit identity + distance; the
    # light's own table supplies its surface normal (le_pdf hit_n=None)
    mis_tmax = jnp.full((N,), FLOAT_MAX)
    if mask is not None:
        mis_tmax = jnp.where(mask, mis_tmax, 0.0)
    hit2_t, hit2_prim = ctx.intersect_tprim(o2, wi2, mis_tmax)

    ld_light = ls.li * f * (cos_term * weight / safe_li_pdf)[:, None]
    ok = ls.present & (ls.pdf != 0) & f_pres & (f_pdf != 0) & ~occluded
    ld_light = jnp.where(ok[:, None], ld_light, 0.0)
    hit2_light = m.take_small(ctx.prim_light, jnp.maximum(hit2_prim, 0))
    hit2_light = jnp.where(hit2_prim >= 0, hit2_light, -1)
    same_light = (hit2_light >= 0) & (hit2_light == light_idx)
    hit2_p = o2 + jnp.where(same_light, hit2_t, 0.0)[:, None] * wi2
    li2 = LT.le_emitted(light_L, jnp.where(same_light, light_idx, -1))
    li2_pdf = LT.le_pdf(
        ctx.lights, jnp.where(same_light, light_idx, -1), p, hit2_p, None
    )
    cos2 = jnp.abs(m.dot(n, wi2))
    safe_f2_pdf = jnp.where(f2_pdf == 0, 1.0, f2_pdf)
    ld_hit = li2 * f2 * (cos2 * m.power_heuristic(f2_pdf, li2_pdf) / safe_f2_pdf)[:, None]
    ok_hit = same_light & (li2_pdf != 0)

    if ctx.envs:
        # escaped-env MIS leg through the CHOSEN light's own map
        chosen_inf = m.take_small(ctx.lights.type_id, light_idx) == LT.TYPE_INFINITE
        eids = m.take_small(jnp.asarray(ctx.lights.env_id), light_idx)
        le3 = jnp.zeros((N, 3), Float)
        le3_pdf = jnp.zeros((N,), Float)
        for eid, env in enumerate(ctx.envs):
            sel_e = eids == eid
            le3 = jnp.where(sel_e[:, None], LT.eval_env(env, wi2), le3)
            le3_pdf = jnp.where(sel_e, LT.env_out_scene_pdf(env, wi2), le3_pdf)
        le3 = le3 * m.take_small(light_L, light_idx)
        ld_esc = le3 * f2 * (cos2 * m.power_heuristic(f2_pdf, le3_pdf) / safe_f2_pdf)[:, None]
        ok_esc = (hit2_prim < 0) & chosen_inf & (le3_pdf != 0)
    else:
        ld_esc = jnp.zeros((N, 3), Float)
        ok_esc = jnp.zeros((N,), bool)

    ld_bsdf = jnp.where(ok_hit[:, None], ld_hit, jnp.where(ok_esc[:, None], ld_esc, 0.0))
    ld_bsdf = jnp.where(
        ((~chosen_delta) & f2_pres & (f2_pdf != 0))[:, None], ld_bsdf, 0.0
    )

    return (ld_light + ld_bsdf) * Float(ctx.n_lights)


def _bounce_dims(dim_base: int, bounce: int):
    return dim_base + DIMS_PER_BOUNCE * bounce


def _sampler_dict(indices, dim0: int, cfg: HaltonConfig, perms):
    return {
        "light_pick": halton_sample(indices, dim0 + D_LIGHT_PICK, cfg, perms),
        "light_u": halton_sample(indices, dim0 + D_LIGHT_U, cfg, perms),
        "light_v": halton_sample(indices, dim0 + D_LIGHT_V, cfg, perms),
        "nee_u": halton_sample(indices, dim0 + D_NEE_U, cfg, perms),
        "nee_v": halton_sample(indices, dim0 + D_NEE_V, cfg, perms),
        "bsdf_bucket": halton_sample(indices, dim0 + D_BSDF_BUCKET, cfg, perms),
        "bsdf_extra": halton_sample(indices, dim0 + D_BSDF_EXTRA, cfg, perms),
        "rr": halton_sample(indices, dim0 + D_RR, cfg, perms),
    }


_U_KEYS = ("light_pick", "light_u", "light_v", "nee_u", "nee_v",
           "bsdf_bucket", "bsdf_extra", "rr")


def path_trace(
    ctx: ShadeContext,
    params,
    o, d,  # (N,3) camera rays
    indices,  # (N,) halton indices
    cfg: HaltonConfig,
    perms,
    max_depth: int,
    dim_base: int,
    count_rays: bool = False,
):
    """PathIntegrator::li over a ray batch → (N,3) radiance.

    The depth loop is a `lax.scan` over bounces — XLA compiles ONE bounce
    body (intersect + NEE + BSDF sample) instead of max_depth copies, which
    cuts compile time several-fold. The per-bounce Halton values use static dim
    indices, so they are precomputed for every bounce up front and fed to
    the scan as a stacked (max_depth, 8, N) input. Bounce-index-dependent
    behavior (bounce-0 emission, RR after bounce 3 — path.rs:21-29,47-56)
    becomes data-dependent masks on the carried bounce counter.

    With count_rays=True returns (radiance, segments) where segments counts
    traced ray segments (closest + shadow + MIS over working lanes) — the
    bench.py rays/sec numerator.
    """
    N = o.shape[0]
    light_L = params["light_L"]
    mat_all_delta = jnp.asarray(ctx.mat_is_all_delta)

    # precompute every bounce's sampler values: (max_depth, 8, N). The RR
    # dim is only consumed past bounce 3 (rr_on = bounce > 3 below); for
    # earlier bounces a zero plane is fed instead of evaluating the
    # radical inverse — bit-identical output (kill is False either way),
    # ~10% less sampler arithmetic at depth 5.
    if max_depth > 0:
        u_all = jnp.stack(
            [
                jnp.stack(
                    [
                        jnp.zeros_like(indices, Float)
                        if (k == D_RR and b <= 3)
                        else halton_sample(
                            indices, _bounce_dims(dim_base, b) + k, cfg, perms)
                        for k in range(DIMS_PER_BOUNCE)
                    ]
                )
                for b in range(max_depth)
            ]
        )

    def emission(L, beta, gate, hit_prim, hit_valid, d):
        hit_light = m.take_small(ctx.prim_light, jnp.maximum(hit_prim, 0))
        hit_light = jnp.where(hit_prim >= 0, hit_light, -1)
        le = LT.le_emitted(light_L, jnp.where(gate, hit_light, -1))
        L = L + beta * le
        esc = LT.le_out_scene_total(ctx.lights, ctx.envs, light_L, d)
        return L + jnp.where((gate & ~hit_valid)[:, None], beta * esc, 0.0)

    def bounce_body(carry, u_rows):
        o, d, L, beta, active, specular, bounce, segments = carry
        u = dict(zip(_U_KEYS, u_rows))
        # dead lanes carry a stale ray; t_max 0 makes every box test in the
        # intersector fail instantly for them instead of re-traversing (the
        # kernel's _box_enter gates on t_best > 0 explicitly, so even a
        # stale origin sitting inside a cluster AABB cannot enter it)
        lane_tmax = jnp.where(active, FLOAT_MAX, 0.0)
        hit = ctx.intersect(o, d, lane_tmax)
        segments = segments + jnp.sum(active.astype(Float))

        gate = active & ((bounce == 0) | specular)
        L = emission(L, beta, gate, hit.prim, hit.valid, d)

        mat_ids = m.take_small(ctx.prim_mat, jnp.maximum(hit.prim, 0))
        mat_ids = jnp.where(hit.prim >= 0, mat_ids, -1)
        active = active & hit.valid & (mat_ids >= 0)  # (path.rs:30-34,64)

        frame = _shading_frame(hit.n)
        wo = -d
        is_all_delta = m.take_small(mat_all_delta, jnp.maximum(mat_ids, 0))

        # one lobe build serves NEE (eval + sample) and the continuation
        fam_lobes = build_family_lobes(ctx, mat_ids, hit.uv, params)
        shaded = active & ~is_all_delta
        nee = uniform_sample_one_light(
            ctx, params, hit, mat_ids, wo, frame, u, fam_lobes, mask=shaded
        )
        L = L + jnp.where(shaded[:, None], beta * nee, 0.0)
        segments = segments + 2.0 * jnp.sum(shaded.astype(Float))

        # continuation (path.rs:41-46)
        fx, fy, fz = frame
        wo_l = m.to_local(wo, fx, fy, fz)
        wi_l, f, pdf, pres, is_delta = shade_sample(
            ctx, fam_lobes, mat_ids, wo_l, u["bsdf_bucket"], u["bsdf_extra"]
        )
        wi = m.to_world(wi_l, fx, fy, fz)
        cont = active & pres & (pdf != 0)
        safe_pdf = jnp.where(pdf == 0, 1.0, pdf)
        throughput = f * (jnp.abs(m.dot(wi, hit.n)) / safe_pdf)[:, None]
        beta = jnp.where(cont[:, None], beta * throughput, beta)
        o = jnp.where(
            cont[:, None], offset_point_by_error(hit.p, hit.n, hit.p_error, wi), o
        )
        d = jnp.where(cont[:, None], wi, d)
        specular = jnp.where(cont, is_delta, specular)
        active = cont

        # Russian roulette after bounce 3 (path.rs:47-56)
        rr_on = bounce > 3
        q = jnp.maximum(0.05, 1.0 - B.luminance(beta))
        kill = rr_on & (u["rr"] < q)
        active = active & ~kill
        beta = jnp.where(rr_on, beta / jnp.maximum(1.0 - q, 1e-6)[:, None], beta)
        return (o, d, L, beta, active, specular, bounce + 1, segments), None

    carry = (
        o, d,
        jnp.zeros((N, 3), Float), jnp.ones((N, 3), Float),
        jnp.ones((N,), bool), jnp.zeros((N,), bool),
        jnp.zeros((), jnp.int32), jnp.zeros((), Float),
    )
    if max_depth > 0:
        carry, _ = jax.lax.scan(bounce_body, carry, u_all)
    o, d, L, beta, active, specular, bounce, segments = carry

    # final iteration (bounce == max_depth): emission only, then stop —
    # slim (t, prim) traversal; no attributes needed past the last shade
    _t_f, prim_f = ctx.intersect_tprim(o, d, jnp.where(active, FLOAT_MAX, 0.0))
    segments = segments + jnp.sum(active.astype(Float))
    gate = active & ((bounce == 0) | specular)
    L = emission(L, beta, gate, prim_f, prim_f >= 0, d)

    if count_rays:
        return L, segments
    return L


def direct_light_trace(
    ctx: ShadeContext,
    params,
    o, d,
    indices,
    cfg: HaltonConfig,
    perms,
    max_depth: int,
    dim_base: int,
    max_delta_lobes: int,
    count_rays: bool = False,
):
    """DirectLightIntegrator::li — NEE at the hit plus recursion through the
    delta lobes (direct_light.rs:12-42).

    The reference enumerates EVERY delta branch per ray (cheap per-ray on
    CPU); on the device each branch would be a full-batch trace, so glass at depth
    d costs 2^d batch renders. Instead each lane stochastically follows ONE
    delta lobe, luminance-weighted through the same Distribution1D the
    reference's sample_delta_f uses (bxdf/mod.rs:160-175), reweighted by
    1/p — an unbiased estimator of the same sum in O(depth) batch traces.
    The lobe choice consumes the bounce's D_BSDF_BUCKET sampler dim, so
    renders stay deterministic.
    """
    light_L = params["light_L"]

    def level(o, d, weight, live, depth):
        """Returns (radiance, segments): segments counts traced ray segments
        over useful lanes (closest-hit per live lane + NEE shadow/MIS pair
        per shaded lane) — same accounting as path_trace's, so bench.py's
        rays/sec unit is uniform across integrators."""
        N = o.shape[0]
        out = jnp.zeros((N, 3), Float)
        hit = ctx.intersect(o, d, jnp.where(live, FLOAT_MAX, 0.0))
        segments = jnp.sum(live.astype(Float))
        hit_light = m.take_small(ctx.prim_light, jnp.maximum(hit.prim, 0))
        hit_light = jnp.where(hit.prim >= 0, hit_light, -1)
        mat_ids = m.take_small(ctx.prim_mat, jnp.maximum(hit.prim, 0))
        mat_ids = jnp.where(hit.prim >= 0, mat_ids, -1)
        has_mat = hit.valid & (mat_ids >= 0) & live

        # le for light-prims (direct_light.rs:33-35), escaped env otherwise
        le = LT.le_emitted(light_L, jnp.where(live & (hit_light >= 0), hit_light, -1))
        out = out + weight * le
        esc = LT.le_out_scene_total(ctx.lights, ctx.envs, light_L, d)
        out = out + jnp.where((live & ~hit.valid)[:, None], weight * esc, 0.0)

        dim0 = dim_base + DIMS_PER_BOUNCE * depth
        u = _sampler_dict(indices, dim0, cfg, perms)
        frame = _shading_frame(hit.n)
        wo = -m.normalize(d)
        fam_lobes = build_family_lobes(ctx, mat_ids, hit.uv, params)
        nee = uniform_sample_one_light(
            ctx, params, hit, mat_ids, wo, frame, u, fam_lobes, mask=has_mat
        )
        out = out + jnp.where(has_mat[:, None], weight * nee, 0.0)
        segments = segments + 2.0 * jnp.sum(has_mat.astype(Float))

        if depth + 1 < max_depth and max_delta_lobes > 0:
            fx, fy, fz = frame
            wo_l = m.to_local(wo, fx, fy, fz)
            bwi = jnp.zeros((N, 3), Float)
            bf = jnp.zeros((N, 3), Float)
            bpdf = jnp.zeros((N,), Float)
            bok = jnp.zeros((N,), bool)
            for fam, all_lobes in fam_lobes:
                lobes = [l for l in all_lobes if l.is_delta]
                if not lobes:
                    continue
                wi_l, f_l, p_l, ok_l = B.bsdf_sample_delta(
                    lobes, wo_l, u["bsdf_bucket"]
                )
                sel = fam.mask(mat_ids)
                bwi = jnp.where(sel[:, None], m.to_world(wi_l, fx, fy, fz), bwi)
                bf = jnp.where(sel[:, None], f_l, bf)
                bpdf = jnp.where(sel, p_l, bpdf)
                bok = jnp.where(sel, ok_l, bok)
            blive = has_mat & bok & (bpdf > 0)
            cosw = jnp.abs(m.dot(hit.n, bwi))
            bo = offset_point_by_error(hit.p, hit.n, hit.p_error, bwi)
            safe_pdf = jnp.where(bpdf > 0, bpdf, 1.0)
            wnext = jnp.where(
                blive[:, None], weight * bf * (cosw / safe_pdf)[:, None], 0.0
            )
            sub_out, sub_seg = level(bo, bwi, wnext, blive, depth + 1)
            out = out + sub_out
            segments = segments + sub_seg
        return out, segments

    N = o.shape[0]
    out, segments = level(o, d, jnp.ones((N, 3), Float), jnp.ones((N,), bool), 0)
    if count_rays:
        return out, segments
    return out
