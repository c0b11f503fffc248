"""Render orchestration: scene → chunked, jitted wavefront rendering → film.

Replaces the reference's rayon tile loop (/root/reference/src/render.rs:7-50)
with pixel-major ray batches: the film is split into fixed-size pixel chunks
(the device analog of 16×16 tiles — sized for device-memory residency
rather than cache lines); each chunk renders all its spp samples in one jitted wavefront call
and reduces to per-pixel means on device (no mutex, no scatter — samples for
a pixel are contiguous lanes). One XLA compilation serves every chunk.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from curry_pbrt_tpu.dtypes import Float
from curry_pbrt_tpu.models import integrators as I
from curry_pbrt_tpu.models.camera import generate_rays
from curry_pbrt_tpu.models.materials import (
    build_families,
    lobe_kinds,
    with_family_tables,
)
from curry_pbrt_tpu.ops import film as F
from curry_pbrt_tpu.ops import intersect as isect
from curry_pbrt_tpu.ops.halton import (
    compute_pixel_offsets,
    halton_indices,
    halton_sample_2d,
    make_halton_config,
    make_permutations,
)
from curry_pbrt_tpu.sceneio.compiler import Scene, compile_scene_file
from curry_pbrt_tpu.utils.imageio import write_png
from curry_pbrt_tpu.utils.logging import get_logger, progress

log = get_logger(__name__)


# Scenes up to this many primitives render fastest through the dense brute
# intersector on the GPU; larger ones through the Triton cluster kernel
# (measured per scene size, PERF.md).
GPU_BRUTE_MAX_PRIMS = 64


def default_backend(scene: Scene) -> str:
    """Default intersector for a scene on the current JAX backend.

    GPU: the dense brute path for the smallest scenes, the cluster-culled
    Pallas kernel (compiled through Triton) beyond GPU_BRUTE_MAX_PRIMS —
    the rule PERF.md records. The CPU has no compiled kernel, so small
    scenes use the dense jnp brute path and large ones the flat BVH."""
    n_prims = scene.tris.count + scene.spheres.count
    if jax.default_backend() == "gpu":
        return "brute" if n_prims <= GPU_BRUTE_MAX_PRIMS else "pallas"
    return "brute" if n_prims <= 256 else "bvh"


def make_shade_context(scene: Scene, intersector: Optional[str] = None) -> I.ShadeContext:
    """Build the static shading context; select the intersector backend."""
    tris, sph = scene.tris, scene.spheres

    backend = intersector if intersector is not None else default_backend(scene)
    if backend == "brute":
        inter = partial(isect.intersect_brute, tris=tris, sph=sph)
        pred = partial(isect.intersect_predicate_brute, tris=tris, sph=sph)
        tprim = partial(isect.intersect_tprim_brute, tris=tris, sph=sph)
    elif backend == "bvh":
        from curry_pbrt_tpu.ops.bvh import build_flat_bvh, make_bvh_intersectors

        bvh = build_flat_bvh(scene)
        inter, pred, tprim = make_bvh_intersectors(bvh, tris, sph)
    elif backend == "pallas":
        from curry_pbrt_tpu.ops.pallas.aggregate import make_pallas_intersectors

        cam_pos = np.asarray(scene.camera.camera_to_world)[:3, 3]
        inter, pred, tprim = make_pallas_intersectors(tris, sph, view_origin=cam_pos)
    else:
        raise ValueError(f"unknown intersector {backend!r}")

    # only materials actually referenced by primitives participate in shading
    used_ids = set(np.asarray(scene.prim_mat).tolist()) - {-1}
    used = [mat for mat in scene.materials if mat.mat_id in used_ids]
    # mix constituents are evaluated through their parent; registry entries
    # needn't be in the loop themselves unless also bound to primitives

    n_mats = max((mat.mat_id for mat in scene.materials), default=-1) + 1
    all_delta = np.zeros((max(n_mats, 1),), bool)
    for mat in scene.materials:
        try:
            kinds = lobe_kinds(mat, scene.material_registry)
        except KeyError:
            kinds = []
        all_delta[mat.mat_id] = bool(kinds) and all(k in ("spec_r", "spec_t") for k in kinds)

    return I.ShadeContext(
        materials=used,
        families=build_families(used),
        registry=scene.material_registry,
        lights=scene.lights,
        envs=scene.envs,
        n_lights=scene.n_lights,
        mat_is_all_delta=all_delta,
        intersect=inter,
        predicate=pred,
        intersect_tprim=tprim,
        prim_mat=scene.prim_mat,
        prim_light=scene.prim_light,
    )


# Rays per chunk for each intersector (swept on the H100, PERF.md).
CHUNK_RAYS = {"pallas": 1 << 19, "brute": 1 << 20, "bvh": 1 << 20}


@dataclass
class RenderPlan:
    scene: Scene
    ctx: I.ShadeContext
    cfg: object  # HaltonConfig
    perms: np.ndarray
    pixel_offsets: np.ndarray  # (H, W) uint32
    chunk_pixels: int
    dim_base: int

    def max_delta_lobes(self) -> int:
        best = 0
        for mat in self.ctx.materials:
            kinds = lobe_kinds(mat, self.scene.material_registry)
            best = max(best, sum(1 for k in kinds if k in ("spec_r", "spec_t")))
        return best


def plan_render(
    scene: Scene, intersector: Optional[str] = None, chunk_pixels: Optional[int] = None
) -> RenderPlan:
    xres, yres = scene.settings.resolution
    spp = scene.settings.spp
    cfg = make_halton_config((xres, yres), spp, seed=scene.settings.seed)
    perms = make_permutations(cfg.seed)
    offs = compute_pixel_offsets(cfg)[:yres, :xres]
    if chunk_pixels is None:
        backend_used = intersector or default_backend(scene)
        if backend_used not in CHUNK_RAYS:
            raise ValueError(f"unknown intersector {backend_used!r}")
        target_rays = CHUNK_RAYS[backend_used]
        n_prims = scene.tris.count + scene.spheres.count
        if backend_used == "brute" and n_prims > 0:
            # dense (rays × prims) buffers: rays·prims ≤ 2^26
            target_rays = min(target_rays, max((1 << 26) // n_prims, 1 << 12))
        # floor on RAYS (not pixels): at 256 spp a 256-pixel floor would
        # double the chunk
        n_pixels = xres * yres
        min_pixels = min(-(-4096 // max(spp, 1)), n_pixels)
        chunk_pixels = max(min(target_rays // max(spp, 1), n_pixels), min_pixels)
    dim_base = 4 if scene.camera.has_lens else 2
    return RenderPlan(
        scene=scene,
        ctx=make_shade_context(scene, intersector),
        cfg=cfg,
        perms=perms,
        pixel_offsets=offs,
        chunk_pixels=chunk_pixels,
        dim_base=dim_base,
    )


def _chunk_sample_radiance(plan: RenderPlan, params, pix_offsets, pix_xy,
                           count_rays=False):
    """Per-SAMPLE radiance for one pixel chunk (shared by the box and
    filter-splat film paths). pix_offsets: (C,) uint32; pix_xy: (C,2) f32
    integer pixel coords. Returns (radiance (C·spp,3), film_xy (C·spp,2))
    and, with count_rays, the traced-segment count."""
    scene, cfg = plan.scene, plan.cfg
    spp = scene.settings.spp
    C = pix_offsets.shape[0]
    offs = jnp.repeat(pix_offsets, spp)
    sample_idx = jnp.tile(jnp.arange(spp, dtype=jnp.uint32), (C,))
    indices = halton_indices(offs, sample_idx, cfg)

    jitter = halton_sample_2d(indices, 0, cfg, plan.perms) - 0.5
    film_xy = jnp.repeat(pix_xy, spp, axis=0) + jitter
    lens_u = (
        halton_sample_2d(indices, 2, cfg, plan.perms) if scene.camera.has_lens else None
    )
    o, d = generate_rays(scene.camera, film_xy, lens_u)

    if scene.settings.integrator == "path":
        out = I.path_trace(
            plan.ctx, params, o, d, indices, cfg, plan.perms,
            scene.settings.max_depth, plan.dim_base, count_rays=count_rays,
        )
    elif scene.settings.integrator == "directlighting":
        out = I.direct_light_trace(
            plan.ctx, params, o, d, indices, cfg, plan.perms,
            scene.settings.max_depth, plan.dim_base, plan.max_delta_lobes(),
            count_rays=count_rays,
        )
    else:
        raise ValueError(scene.settings.integrator)
    if count_rays:
        return out[0], film_xy, out[1]
    return out, film_xy


def _render_chunk(plan: RenderPlan, params, pix_offsets, pix_xy, nan_counts=False):
    """(C, 3) pixel radiance (box-filtered mean over spp); with
    nan_counts=True also (C,) dropped-NaN-sample counts."""
    radiance, _ = _chunk_sample_radiance(plan, params, pix_offsets, pix_xy)
    return F.accumulate_box(radiance, plan.scene.settings.spp,
                            return_nan_counts=nan_counts)


def _render_chunk_stats(plan: RenderPlan, params, pix_offsets, pix_xy):
    """Like _render_chunk but also returns traced-segment count (bench)."""
    radiance, _, segments = _chunk_sample_radiance(
        plan, params, pix_offsets, pix_xy, count_rays=True
    )
    return F.accumulate_box(radiance, plan.scene.settings.spp), segments


def _render_chunk_splat(plan: RenderPlan, params, pix_offsets, pix_xy,
                        n_pixels: int):
    """One chunk's FULL-FILM filter-splat contribution: (film (n_pixels,3),
    wsum (n_pixels,), nan_count). A sample's tent footprint may cross chunk
    boundaries, so each chunk scatters into a whole-film accumulator (summed
    across chunks by the caller) through filter_splat's custom VJP."""
    radiance, film_xy = _chunk_sample_radiance(plan, params, pix_offsets, pix_xy)
    xres, yres = plan.scene.settings.resolution
    rad4, ids4, w4 = F.triangle_taps(film_xy, radiance, xres, yres)
    film, wsum = F.filter_splat(rad4, ids4, w4, n_pixels)
    n_bad = jnp.sum(jnp.any(jnp.isnan(radiance), axis=-1))
    return film, wsum, n_bad


def _chunked_pixel_arrays(plan: RenderPlan):
    """Host-side (K, C) pixel-offset and (K, C, 2) pixel-xy chunk arrays,
    padded to a whole number of chunks."""
    xres, yres = plan.scene.settings.resolution
    n_pixels = xres * yres
    C = plan.chunk_pixels
    K = (n_pixels + C - 1) // C
    ys, xs = np.mgrid[0:yres, 0:xres]
    pix_xy = np.stack([xs.ravel(), ys.ravel()], axis=-1).astype(np.float32)
    offs = plan.pixel_offsets.reshape(-1)
    pad = K * C - n_pixels
    po = np.pad(offs, (0, pad)).reshape(K, C)
    px = np.pad(pix_xy, ((0, pad), (0, 0))).reshape(K, C, 2)
    return po, px, n_pixels


def _render_all(plan: RenderPlan, params, po_chunks, px_chunks, tick=None):
    """Whole-film render in ONE dispatch: `lax.map` over pixel chunks keeps
    peak memory at one chunk's working set while XLA compiles the bounce
    pipeline once, with no host round trip between chunks.

    Returns (imgs, nan_total, worst_xy): NaN-drop stats aggregate on device
    and are logged host-side after the fetch (reference warns per sample —
    render.rs:34-40). `tick`, if given, is a per-chunk progress callback."""

    def one(c):
        img, bad = _render_chunk(plan, params, c[0], c[1], nan_counts=True)
        n_bad = jnp.sum(bad)
        worst = jnp.argmax(bad)
        xy = c[1][worst]
        if tick is not None:
            jax.debug.callback(lambda _: tick(1), n_bad)
        return img, n_bad, jnp.where(n_bad > 0, xy, jnp.full((2,), -1.0, Float))

    imgs, bad_counts, worst_xys = jax.lax.map(one, (po_chunks, px_chunks))
    total = jnp.sum(bad_counts)
    worst_chunk = jnp.argmax(bad_counts)
    return imgs, total, worst_xys[worst_chunk]


def _render_all_splat(plan: RenderPlan, params, po_chunks, px_chunks,
                      n_pixels: int):
    """Whole-film filter-splat render in one dispatch: a `lax.scan` over
    pixel chunks carrying the (film, wsum) accumulators — chunks must
    accumulate (tent footprints cross chunk edges), so the box path's
    independent per-chunk map doesn't apply. Returns un-normalized
    (film, wsum, nan_total)."""

    def body(carry, c):
        film, wsum, nan_tot = carry
        f, w, n_bad = _render_chunk_splat(plan, params, c[0], c[1], n_pixels)
        return (film + f, wsum + w, nan_tot + n_bad), None

    init = (
        jnp.zeros((n_pixels, 3), Float),
        jnp.zeros((n_pixels,), Float),
        jnp.zeros((), jnp.int32),
    )
    (film, wsum, nan_tot), _ = jax.lax.scan(body, init, (po_chunks, px_chunks))
    return film, wsum, nan_tot


# The most chunks one device execution renders: bigger films run as
# equal-size dispatch groups through the same compiled function, so each
# execution and the per-chunk outputs it returns stay bounded.
MAX_CHUNKS_PER_DISPATCH = 512


def render_scene(
    scene: Scene,
    params=None,
    intersector: Optional[str] = None,
    chunk_pixels: Optional[int] = None,
    show_progress: bool = True,
) -> np.ndarray:
    """Full render → (H, W, 3) float radiance image."""
    plan = plan_render(scene, intersector, chunk_pixels)
    params = with_family_tables(
        plan.ctx.families, scene.init_params if params is None else params)
    xres, yres = scene.settings.resolution
    po, px, n_pixels = _chunked_pixel_arrays(plan)
    k = po.shape[0]
    if k > MAX_CHUNKS_PER_DISPATCH:
        n_groups = -(-k // MAX_CHUNKS_PER_DISPATCH)
        g = -(-k // n_groups)
        pad = n_groups * g - k
        po = np.concatenate([po, np.zeros((pad,) + po.shape[1:], po.dtype)])
        px = np.concatenate([px, np.zeros((pad,) + px.shape[1:], px.dtype)])
        groups = [(po[i * g:(i + 1) * g], px[i * g:(i + 1) * g])
                  for i in range(n_groups)]
    else:
        groups = [(po, px)]

    if scene.settings.filter == "triangle":
        # padding chunks exist host-side only; park their pixel coords far
        # off-film so triangle_taps zero-weights every tap (the box path
        # instead slices padded rows off after the fact)
        px_flat = px.reshape(-1, 2)
        px_flat[n_pixels:] = -8.0
        t0 = time.time()
        fn = jax.jit(partial(_render_all_splat, plan, n_pixels=n_pixels))
        film = np.zeros((n_pixels, 3), np.float32)
        wsum = np.zeros((n_pixels,), np.float32)
        nan_total = 0
        for gpo, gpx in groups:
            f, w, n_bad = fn(params, jnp.asarray(gpo), jnp.asarray(gpx))
            film += np.asarray(f)
            wsum += np.asarray(w)
            nan_total += int(n_bad)
        if nan_total > 0:
            log.warning(
                "dropped %d NaN radiance sample(s) (filter-splat path) — "
                "reference warns per sample (render.rs:34-40)", nan_total,
            )
        out = np.asarray(F.normalize_splat(jnp.asarray(film), jnp.asarray(wsum)))
        log.info("rendered %dx%d @ %d spp (triangle filter) in %.2fs",
                 xres, yres, scene.settings.spp, time.time() - t0)
        return out.reshape(yres, xres, 3)

    live = show_progress and po.shape[0] > 1
    t0 = time.time()
    with progress(po.shape[0], enabled=live) as tick:
        fn = jax.jit(partial(_render_all, plan, tick=tick if live else None))
        img_parts, nan_totals, worst_xys = [], [], []
        for gpo, gpx in groups:
            imgs, nan_g, worst_g = fn(params, jnp.asarray(gpo), jnp.asarray(gpx))
            img_parts.append(np.asarray(imgs))
            nan_totals.append(int(nan_g))
            worst_xys.append(np.asarray(worst_g))
        out = np.concatenate(img_parts, axis=0) if len(img_parts) > 1 else img_parts[0]
        worst_xy = worst_xys[int(np.argmax(nan_totals))]
        nan_total = sum(nan_totals)
    if nan_total > 0:
        x, y = np.asarray(worst_xy)
        log.warning(
            "dropped %d NaN radiance sample(s) (e.g. pixel %d, %d) — "
            "reference warns per sample (render.rs:34-40)",
            nan_total, int(x), int(y),
        )
    out = out.reshape(-1, 3)[:n_pixels]
    log.info("rendered %dx%d @ %d spp in %.2fs", xres, yres, scene.settings.spp, time.time() - t0)
    return out.reshape(yres, xres, 3)


def render_from_file(path, output: Optional[str] = None, overrides=None, **kw) -> str:
    """Full pipeline (render.rs:63-82): parse → compile → render → PNG."""
    scene = compile_scene_file(path, overrides)
    image = render_scene(scene, **kw)
    out_path = output or scene.settings.filename
    u8 = np.asarray(F.to_srgb_u8(jnp.asarray(image)))
    write_png(out_path, u8)
    print(out_path)
    return out_path
