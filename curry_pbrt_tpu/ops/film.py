"""Film accumulation and the differentiable reconstruction splat.

The reference averages each pixel's spp samples with a box filter inside
16×16 tiles and merges under a mutex (/root/reference/src/film.rs:4-19,
src/render.rs:19-45). Here rays are laid out pixel-major — (pixels, spp)
— so accumulation is a pure reshape+masked-mean with no scatter and no
locks, and per-device partial films combine with a `psum`.

NaN radiance samples are dropped per pixel and the remaining samples
averaged, matching render.rs:34-43 (average over the pushed samples only).

`filter_splat` is the general differentiable splat with a custom VJP for
wider reconstruction filters (triangle/Gaussian): forward scatters weighted
radiance into pixels; backward gathers — the custom VJP avoids
differentiating through scatter index computation and detaches the filter
weights' dependence on sample position (positions are not differentiable
parameters; BASELINE.json north star).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from curry_pbrt_tpu.dtypes import Float
from curry_pbrt_tpu.ops.math import gamma_correct


def accumulate_box(radiance, spp: int, return_nan_counts: bool = False):
    """radiance: (P·S, 3) sample radiances laid out pixel-major → (P, 3)
    per-pixel means with NaN samples dropped.

    With return_nan_counts=True also returns (P,) int32 dropped-sample
    counts so the caller can warn with pixel ids (render.rs:34-40 warns per
    NaN sample; we aggregate per chunk — see render._render_all)."""
    r = radiance.reshape(-1, spp, 3)
    bad = jnp.any(jnp.isnan(r), axis=-1, keepdims=True)
    r = jnp.where(bad, 0.0, r)
    count = jnp.sum((~bad).astype(Float), axis=1)
    means = jnp.sum(r, axis=1) / jnp.maximum(count, 1.0)
    if return_nan_counts:
        return means, jnp.sum(bad[..., 0].astype(jnp.int32), axis=1)
    return means


def to_srgb_u8(image):
    """Gamma-corrected 8-bit quantization (film.rs:35-38 + image.rs:108-127:
    clamp(v·255 + 0.5, 0, 255) as u8)."""
    v = gamma_correct(jnp.clip(image, 0.0, jnp.inf))
    return jnp.clip(v * 255.0 + 0.5, 0.0, 255.0).astype(jnp.uint8)


# ---------------------------------------------------------------------------
# general filter splat (beyond-reference capability, used by the
# differentiable renderer when a non-box filter is requested)


from functools import partial


@partial(jax.custom_vjp, nondiff_argnums=(3,))
def filter_splat(radiance, pixel_ids, weights, n_pixels):
    """Scatter-add weighted radiance into a flat film.

    radiance: (M,3); pixel_ids: (M,) int32 (already footprint-expanded);
    weights: (M,); returns (film_rgb: (n_pixels,3), film_w: (n_pixels,)).
    """
    return _splat_fwd_impl(radiance, pixel_ids, weights, n_pixels)


def _splat_fwd_impl(radiance, pixel_ids, weights, n_pixels):
    film = jnp.zeros((n_pixels, 3), Float).at[pixel_ids].add(radiance * weights[:, None])
    wsum = jnp.zeros((n_pixels,), Float).at[pixel_ids].add(weights)
    return film, wsum


def _splat_fwd(radiance, pixel_ids, weights, n_pixels):
    out = _splat_fwd_impl(radiance, pixel_ids, weights, n_pixels)
    return out, (pixel_ids, weights)


def _splat_bwd(n_pixels, res, g):
    pixel_ids, weights = res
    g_film, _g_wsum = g
    # d(film[p])/d(radiance_i) = w_i for p = pixel_ids[i]: backward is a
    # pure gather — weights and indices are detached (positions are not
    # differentiable parameters)
    g_rad = jnp.take(g_film, pixel_ids, axis=0) * weights[:, None]
    return g_rad, None, None


filter_splat.defvjp(_splat_fwd, _splat_bwd)


def normalize_splat(film, wsum):
    return film / jnp.maximum(wsum, 1e-12)[:, None]


def triangle_taps(film_xy, radiance, xres: int, yres: int):
    """Expand each sample into its 4 tent-filter taps for `filter_splat`.

    film_xy: (M,2) continuous sample positions (pixel centers at integer
    coordinates, the generate_rays convention); radiance: (M,3). A
    radius-1 triangle (tent) filter covers exactly the 2×2 integer pixels
    around the sample with bilinear weights w = (1-|dx|)(1-|dy|). Taps
    falling off the film get weight 0 (pbrt discards them); NaN samples get
    weight 0 on all taps (the box path's NaN-drop, render.rs:34-40).

    Returns (rad: (4M,3), pixel_ids: (4M,) i32, weights: (4M,)) — weights
    and ids are detached (sample positions are not differentiable
    parameters; see filter_splat's VJP).
    """
    fx, fy = film_xy[:, 0], film_xy[:, 1]
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    wx1 = fx - x0  # weight of the x0+1 tap
    wy1 = fy - y0
    bad = jnp.any(jnp.isnan(radiance), axis=-1)
    rad = jnp.where(bad[:, None], 0.0, radiance)

    rads, ids, ws = [], [], []
    for ax, ay in ((0, 0), (1, 0), (0, 1), (1, 1)):
        px = x0 + ax
        py = y0 + ay
        w = (wx1 if ax else 1.0 - wx1) * (wy1 if ay else 1.0 - wy1)
        inside = (px >= 0) & (px < xres) & (py >= 0) & (py < yres)
        w = jnp.where(inside & ~bad, w, 0.0)
        pid = jnp.clip(py, 0, yres - 1) * xres + jnp.clip(px, 0, xres - 1)
        rads.append(rad)
        ids.append(pid.astype(jnp.int32))
        ws.append(w)
    return (
        jnp.concatenate(rads, axis=0),
        jnp.concatenate(ids, axis=0),
        jax.lax.stop_gradient(jnp.concatenate(ws, axis=0)),
    )
