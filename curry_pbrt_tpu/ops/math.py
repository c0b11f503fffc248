"""Batched geometric/sampling math on SoA arrays.

Every function here is shape-polymorphic over leading batch dims: vectors are
`(..., 3)` f32 arrays, scalars `(...)`. These replace the reference's scalar
helpers (/root/reference/src/math/mod.rs) with natively-batched jnp code that
XLA fuses onto the VPU; nothing here allocates per-ray Python objects.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from curry_pbrt_tpu.dtypes import INV_PI, PI

# ---------------------------------------------------------------------------
# small vector helpers


def take_small(table, idx, *, max_onehot: int = 256):
    """Row-gather `table[idx]` specialized for SMALL tables.

    For tables up to a few hundred rows a one-hot compare + masked sum
    replaces the per-lane dynamic gather; it is exact (selects never touch
    the values). Falls back to jnp.take above `max_onehot` rows. idx must already be in-range (clip before calling).
    Result shape: idx.shape + table.shape[1:].
    """
    K = table.shape[0]
    if K == 0 or K > max_onehot:
        return jnp.take(table, idx, axis=0)
    if K == 1:
        return jnp.broadcast_to(table[0], idx.shape + table.shape[1:])
    oh = idx[..., None] == jnp.arange(K, dtype=idx.dtype)  # (..., K)
    ohx = oh.reshape(oh.shape + (1,) * (table.ndim - 1))
    if table.dtype == jnp.bool_:
        return jnp.any(ohx & table, axis=idx.ndim)
    return jnp.sum(jnp.where(ohx, table, table.dtype.type(0)), axis=idx.ndim)


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    return jnp.cross(a, b)


def length_sq(v):
    return jnp.sum(v * v, axis=-1)


def length(v):
    return jnp.sqrt(length_sq(v))


def safe_sqrt(x):
    """sqrt clamped at 0 with a NaN-free gradient at the clamp.

    `sqrt(max(x, 0))` has backward `0 · ∞ = NaN` exactly at 0 — and masked
    SoA lanes sit exactly at 0 — so route the gradient through a dummy
    branch instead (double-where)."""
    safe = jnp.where(x <= 0.0, 1.0, x)
    return jnp.where(x <= 0.0, 0.0, jnp.sqrt(safe))


def normalize(v):
    """Unit vector; zero vectors (masked lanes) map to zero with zero — not
    NaN — gradients."""
    l2 = length_sq(v)
    safe = jnp.where(l2 == 0.0, 1.0, l2)
    return v * jax.lax.rsqrt(safe)[..., None]


def lerp(t, a, b):
    return a * (1.0 - t) + b * t


def face_same_hemisphere(v, ref):
    """Flip v so it lies in the hemisphere of ref."""
    s = jnp.sign(dot(v, ref))[..., None]
    return v * jnp.where(s == 0, 1.0, s)


# ---------------------------------------------------------------------------
# frames


def coordinate_system(z):
    """Build (x, y) orthonormal to z. Reference: math/mod.rs:67-74.

    z: (..., 3) unit vectors → (x, y): each (..., 3).
    """
    zx, zy, zz = z[..., 0], z[..., 1], z[..., 2]
    use_x = jnp.abs(zx) > jnp.abs(zy)
    denom = jnp.where(use_x, zx * zx + zz * zz, zy * zy + zz * zz)
    # zero z (masked miss lanes) → zero frame, never inf/NaN
    inv_a = jax.lax.rsqrt(jnp.where(denom == 0.0, 1.0, denom))
    x_a = jnp.stack([-zz, jnp.zeros_like(zx), zx], axis=-1)
    x_b = jnp.stack([jnp.zeros_like(zx), zz, -zy], axis=-1)
    x = jnp.where(use_x[..., None], x_a, x_b) * inv_a[..., None]
    y = cross(z, x)
    return x, y


def to_local(w, x, y, z):
    """World → shading-local coordinates (z = normal)."""
    return jnp.stack([dot(w, x), dot(w, y), dot(w, z)], axis=-1)


def to_world(w, x, y, z):
    """Shading-local → world. Normalized like the reference
    (bxdf/mod.rs:98-111 normalizes both directions)."""
    return x * w[..., 0:1] + y * w[..., 1:2] + z * w[..., 2:3]


# ---------------------------------------------------------------------------
# local-frame trig (z is the normal) — reference math/mod.rs:152-201


def cos_theta(w):
    return w[..., 2]


def cos2_theta(w):
    return w[..., 2] * w[..., 2]


def sin2_theta(w):
    return jnp.maximum(1.0 - cos2_theta(w), 0.0)


def sin_theta(w):
    return safe_sqrt(sin2_theta(w))


def tan_theta(w):
    return sin_theta(w) / cos_theta(w)


def tan2_theta(w):
    return sin2_theta(w) / cos2_theta(w)


def cos_phi(w):
    st = sin_theta(w)
    return jnp.where(st == 0.0, 1.0, jnp.clip(w[..., 0] / jnp.where(st == 0, 1.0, st), -1.0, 1.0))


def sin_phi(w):
    st = sin_theta(w)
    return jnp.where(st == 0.0, 0.0, jnp.clip(w[..., 1] / jnp.where(st == 0, 1.0, st), -1.0, 1.0))


def cos2_phi(w):
    c = cos_phi(w)
    return c * c


def sin2_phi(w):
    s = sin_phi(w)
    return s * s


def cos_delta_phi(wa, wb):
    """Azimuth-difference cosine. Reference math/mod.rs:191-198."""
    num = wa[..., 0] * wb[..., 0] + wa[..., 1] * wb[..., 1]
    den = jnp.sqrt(
        (wa[..., 0] ** 2 + wa[..., 1] ** 2) * (wb[..., 0] ** 2 + wb[..., 1] ** 2)
    )
    return jnp.clip(num / jnp.where(den == 0, 1.0, den), -1.0, 1.0)


# ---------------------------------------------------------------------------
# MIS


def power_heuristic(f, g):
    """β=2 power heuristic. Reference math/mod.rs:32-34. 0/0 → 0 (masked
    lanes feed f = g = 0; a NaN here poisons gradients through the mask)."""
    f2 = f * f
    denom = f2 + g * g
    return jnp.where(denom == 0.0, 0.0, f2 / jnp.where(denom == 0.0, 1.0, denom))


# ---------------------------------------------------------------------------
# sampling primitives — reference math/mod.rs:98-126


def concentric_sample_disk(u):
    """u: (..., 2) in [0,1)² → (..., 2) points on the unit disk."""
    ux = 2.0 * u[..., 0] - 1.0
    uy = 2.0 * u[..., 1] - 1.0
    zero = (ux == 0.0) | (uy == 0.0)
    use_x = jnp.abs(ux) > jnp.abs(uy)
    safe_ux = jnp.where(ux == 0, 1.0, ux)
    safe_uy = jnp.where(uy == 0, 1.0, uy)
    r = jnp.where(use_x, ux, uy)
    theta = jnp.where(
        use_x,
        (PI / 4.0) * (uy / safe_ux),
        (PI / 2.0) - (PI / 4.0) * (ux / safe_uy),
    )
    p = jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1)
    return jnp.where(zero[..., None], 0.0, p)


def uniform_sample_hemisphere(u):
    """u: (..., 2) → unit vectors with z ∈ [-1, 1] (reference samples the
    FULL sphere despite the name — math/mod.rs:111-116; sphere area sampling
    relies on that)."""
    z = 1.0 - 2.0 * u[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * PI * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def cosine_sample_hemisphere(u):
    """u: (..., 2) → (w: (...,3), pdf: (...))."""
    d = concentric_sample_disk(u)
    z = safe_sqrt(1.0 - length_sq(d))
    w = jnp.concatenate([d, z[..., None]], axis=-1)
    return w, z * INV_PI


def uniform_sample_triangle(u):
    """u: (..., 2) → barycentric (b0, b1): (..., 2)."""
    su0 = jnp.sqrt(u[..., 0])
    return jnp.stack([1.0 - su0, u[..., 1] * su0], axis=-1)


def sample_usize_remap(u, n: int):
    """Uniform index in [0, n) plus the remapped residual sample.

    Reference math/mod.rs:84-90. n is static.
    """
    f = u * jnp.float32(n)
    idx = jnp.minimum(f.astype(jnp.int32), n - 1)
    return idx, f - jnp.floor(f)


# ---------------------------------------------------------------------------
# spherical mappings — reference math/mod.rs:135-151


def spherical_to_normalized_phi_theta(w):
    """Unit vector → (phi/2π, theta/π) in [0,1]²; w: (...,3) → (...,2)."""
    p = jnp.arctan2(w[..., 1], w[..., 0])
    p = jnp.where(p < 0.0, p + 2.0 * PI, p)
    u = p * 0.5 * INV_PI
    v = jnp.arccos(jnp.clip(w[..., 2], -1.0, 1.0)) * INV_PI
    return jnp.stack([u, v], axis=-1)


def normalized_phi_theta_to_spherical(uv):
    theta = uv[..., 1] * PI
    phi = uv[..., 0] * 2.0 * PI
    st, ct = jnp.sin(theta), jnp.cos(theta)
    return jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), ct], axis=-1)


# ---------------------------------------------------------------------------
# refraction — reference math/mod.rs:202-211


def refract(wo, n, eta):
    """Refract wo about normal n with relative IOR eta = eta_i/eta_t.

    Returns (wi: (...,3), ok: (...) bool). Total internal reflection → ok=False.
    """
    cos_theta_o = dot(wo, n)
    sin2_theta_o = 1.0 - cos_theta_o * cos_theta_o
    sin2_theta_i = sin2_theta_o * eta * eta
    ok = sin2_theta_i <= 1.0
    cos_theta_i = safe_sqrt(1.0 - sin2_theta_i)
    wi = eta[..., None] * (-wo) + (eta * cos_theta_o - cos_theta_i)[..., None] * n
    return wi, ok


# ---------------------------------------------------------------------------
# gamma (sRGB-ish) transfer — reference math/mod.rs:51-65


def gamma_correct(f):
    return jnp.where(
        f <= 0.0031308, 12.92 * f, 1.055 * jnp.power(jnp.maximum(f, 1e-12), 1.0 / 2.4) - 0.055
    )


def inverse_gamma_correct(f):
    # NOTE: reference divides by 1.05 (math/mod.rs:63) — an sRGB constant typo
    # it applies consistently to loaded textures; we reproduce it so texture
    # values round-trip identically with the reference loader.
    # Backend-agnostic (numpy in, numpy out) so the scene compiler's host-side
    # texture decode shares this one definition (no drift between copies).
    import numpy as _np

    xp = _np if isinstance(f, _np.ndarray) else jnp
    return xp.where(f <= 0.04045, f / 12.92, xp.power((f + 0.055) / 1.05, 2.4))
