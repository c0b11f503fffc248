"""Stateless vectorized Halton sampler.

The reference sampler is a mutable per-thread object: `set_pixel` solves a CRT
to find the Halton index whose first two radical inverses land in the pixel,
`next_sample` strides the index, and `get_sample` walks a dim counter
(/root/reference/src/sampler/halton.rs). Here the same math becomes a pure
function of (pixel, sample_index, dim):

    index(pixel, k) = pixel_offset[pixel] + k * (scale_x * scale_y)
    dim 0: radical_inverse(index / scale_x, base 2)   (pixel-stratifying)
    dim 1: radical_inverse(index / scale_y, base 3)
    dim d >= 2: scrambled_radical_inverse(index, prime[d]) with SEEDED digit
    permutations (the reference uses thread_rng — halton.rs:216-231 — which
    makes its renders nondeterministic; we seed so images are reproducible).

Scrambling uses per-prime AFFINE digit permutations π(d) = (a·d + b) mod p
with seeded a ∈ [1,p), b ∈ [0,p) — the Faure-Lemieux linear-scrambling
family. The reference draws an arbitrary random permutation per prime
(halton.rs:216-231); any seeded permutation family is an equally valid
instance of the same estimator, and the affine form evaluates in ~5
elementwise ops per digit instead of a base-wide one-hot table contraction
(the bounce dims dominate the sampler cost).

`pixel_offset` is precomputed host-side with numpy (it is a pure function of
the pixel grid), so the device only does the per-(ray, dim) digit loops —
fixed trip counts, fully unrolled, no data-dependent control flow.

The prime table covers the reference's full 1000 primes (halton.rs:141-203);
dims >= MAX_DIMS fall back to a counter-based hash RNG (threefry-lite),
mirroring the reference's `rand::random` fallback (halton.rs:130-132).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from curry_pbrt_tpu.dtypes import Float


def _first_primes(n: int) -> list:
    """Sieve the first n primes (reference table: halton.rs:141-203)."""
    # n-th prime < n (ln n + ln ln n) for n >= 6; 1000th prime = 7919
    limit = max(int(n * (np.log(n) + np.log(np.log(n)))) + 10, 30)
    sieve = np.ones(limit, bool)
    sieve[:2] = False
    for p in range(2, int(limit**0.5) + 1):
        if sieve[p]:
            sieve[p * p :: p] = False
    primes = np.nonzero(sieve)[0][:n]
    assert len(primes) == n
    return [int(p) for p in primes]


PRIMES = _first_primes(1000)
MAX_DIMS = len(PRIMES)

ONE_MINUS_EPS = Float(np.nextafter(np.float32(1.0), np.float32(0.0)))


def _max_digits(base: int) -> int:
    """Digits needed to exhaust a uint32 in `base`."""
    n, d = 1, 0
    while n < 2**32:
        n *= base
        d += 1
    return d


def make_permutations(seed: int) -> np.ndarray:
    """Seeded affine digit-permutation coefficients per prime.

    Returns (MAX_DIMS, 2) int32: row i = (a_i, b_i) defining the digit
    permutation π_i(d) = (a_i·d + b_i) mod PRIMES[i], a_i ∈ [1, p), so π is a
    bijection on [0, p). Replaces the reference's full random permutation
    tables (halton.rs:216-231) with an equally-seeded permutation family that
    evaluates arithmetically on device (no table gathers)."""
    rng = np.random.RandomState(seed)
    out = np.empty((MAX_DIMS, 2), dtype=np.int32)
    for i, p in enumerate(PRIMES):
        out[i, 0] = 1 if p == 2 else rng.randint(1, p)
        out[i, 1] = rng.randint(0, p)
    return out


class HaltonConfig(NamedTuple):
    """Static per-render sampler config (all Python ints / host arrays)."""

    scale_x: int
    scale_y: int
    exp_x: int
    exp_y: int
    spp: int
    seed: int

    @property
    def scale_prod(self) -> int:
        return self.scale_x * self.scale_y

    @property
    def max_index(self) -> int:
        """Exclusive upper bound on any Halton index this render produces:
        index = pixel_offset + sample_idx·scale_prod with pixel_offset <
        scale_prod and sample_idx < spp (halton_indices). Digit loops only
        need enough digits to cover this bound — every higher digit is
        provably zero, so truncating them is bit-exact (not an
        approximation)."""
        return self.scale_prod * max(self.spp, 1)


def make_halton_config(resolution, spp: int, seed: int = 0) -> HaltonConfig:
    xres, yres = int(resolution[0]), int(resolution[1])
    scale, exp = [1, 1], [0, 0]
    for i, base in enumerate((2, 3)):
        while scale[i] < (xres, yres)[i]:
            scale[i] *= base
            exp[i] += 1
    return HaltonConfig(scale[0], scale[1], exp[0], exp[1], spp, seed)


def _mult_inverse(a: int, n: int) -> int:
    return pow(a, -1, n)


def compute_pixel_offsets(cfg: HaltonConfig) -> np.ndarray:
    """(yres_pad?, …) no — returns (scale-independent) offset per pixel of the
    FULL scale grid restricted to [0,xres)×[0,yres): here computed for all
    pixel coordinates on a (H, W) grid, H=scale_y bound by caller's slicing.

    Returns uint32 array of shape (yres, xres) — entry [y, x] is the smallest
    Halton index whose first two scaled radical inverses land in pixel (x, y).
    Mirrors halton.rs:108-119 with vectorized numpy.
    """
    # digit-reverse x in base 2 with exp_x digits; y in base 3 with exp_y digits
    def inverse_exp(vals: np.ndarray, base: int, exp: int) -> np.ndarray:
        x = vals.astype(np.int64)
        acc = np.zeros_like(x)
        digit_count = np.zeros_like(x)
        for _ in range(max(exp, 1)):
            nz = x != 0
            digit = x % base
            x = x // base
            acc = np.where(nz, acc * base + digit, acc)
            digit_count = np.where(nz, digit_count + 1, digit_count)
        pad = np.maximum(exp - digit_count, 0)
        return acc * np.power(base, pad)

    xs = inverse_exp(np.arange(0, cfg.scale_x, dtype=np.int64), 2, cfg.exp_x)
    ys = inverse_exp(np.arange(0, cfg.scale_y, dtype=np.int64), 3, cfg.exp_y)
    minv_x = _mult_inverse(cfg.scale_y, cfg.scale_x) if cfg.scale_x > 1 else 0
    minv_y = _mult_inverse(cfg.scale_x, cfg.scale_y) if cfg.scale_y > 1 else 0
    offs = (
        xs[None, :] * cfg.scale_y * minv_x + ys[:, None] * cfg.scale_x * minv_y
    ) % cfg.scale_prod
    return offs.astype(np.uint32)


def halton_indices(pixel_offsets, sample_idx, cfg: HaltonConfig):
    """pixel_offsets: (...,) uint32 gathered for each ray; sample_idx (...,)."""
    return pixel_offsets + sample_idx.astype(jnp.uint32) * jnp.uint32(cfg.scale_prod)


def _digits_for(base: int, max_index) -> int:
    """Digit-loop trip count: enough base-`base` digits to cover every
    index < max_index (None → the full uint32 range). Truncating beyond
    this is EXACT — those digits are zero for every producible index."""
    full = _max_digits(base)
    if not max_index or max_index <= 0:
        return full
    k, cap = 0, 1
    while cap < max_index and k < full:
        cap *= base
        k += 1
    return k if cap >= max_index else full


def radical_inverse(x, base: int, max_index=None):
    """Plain radical inverse of uint32 x in `base`.

    The reference accumulates the digit-reversed integer then divides by
    b^digit_count (halton.rs:36-69); that integer overflows 32 bits for
    bases ≥ 3, so we accumulate the mathematically-identical per-digit sum
    Σ_j digit_j · b^-(j+1) in f32 instead (LSB digit first). max_index
    bounds the digit loop (bit-exact, see _digits_for).
    """
    b = jnp.uint32(base)
    r = jnp.zeros(x.shape, dtype=Float)
    w = Float(1.0 / base)
    for _ in range(_digits_for(base, max_index)):
        nz = x != 0
        digit = x % b
        x = x // b
        r = jnp.where(nz, r + digit.astype(Float) * w, r)
        w = w * Float(1.0 / base)
    return r


def scrambled_radical_inverse(x, dim: int, perms, max_index=None):
    """Scrambled radical inverse with per-base affine digit permutation.

    Matches the reference's scrambled accumulation (halton.rs:25-63) including
    the permuted-zero tail term b^-dc · (1/b)·π(0)/(1 − 1/b), which accounts
    for the infinite run of zero digits above the top digit all mapping
    through the permutation. π(d) = (a·d + b) mod p computed arithmetically —
    ~5 VPU ops per digit; no table, no gather, no one-hot."""
    base = PRIMES[dim]
    a = int(np.asarray(perms[dim, 0]))
    c = int(np.asarray(perms[dim, 1]))
    b = jnp.uint32(base)
    au = jnp.uint32(a)
    cu = jnp.uint32(c)
    r = jnp.zeros(x.shape, dtype=Float)
    w = Float(1.0 / base)
    digit_count = jnp.zeros(x.shape, dtype=jnp.int32)
    for _ in range(_digits_for(base, max_index)):
        nz = x != 0
        digit = x % b
        x = x // b
        pd = (digit * au + cu) % b  # affine permutation; fits u32 (p < 2^13)
        r = jnp.where(nz, r + pd.astype(Float) * w, r)
        digit_count = jnp.where(nz, digit_count + 1, digit_count)
        w = w * Float(1.0 / base)
    inv_base = Float(1.0 / base)
    inv_base_n = jnp.power(Float(base), -digit_count.astype(Float))
    tail = inv_base * Float(float(c)) / (1.0 - inv_base)  # π(0) = c
    return r + inv_base_n * tail


def _hash_u32(x, salt):
    """Cheap counter-based RNG for dims past the prime table (the reference
    falls back to rand::random — halton.rs:130-132). xxhash-style mixing."""
    x = x ^ jnp.uint32(salt)
    x = x * jnp.uint32(0x85EBCA6B)
    x = x ^ (x >> 13)
    x = x * jnp.uint32(0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def halton_sample(indices, dim: int, cfg: HaltonConfig, perms):
    """Sample value for static `dim` at each Halton index. indices: (...,)
    uint32 → f32 in [0, 1). Matches HaltonSampler::get_sample + get_1d clamp
    (sampler/mod.rs:10-17)."""
    mi = cfg.max_index
    if dim == 0:
        r = radical_inverse(indices // jnp.uint32(cfg.scale_x), 2,
                            max_index=-(-mi // cfg.scale_x))
    elif dim == 1:
        r = radical_inverse(indices // jnp.uint32(cfg.scale_y), 3,
                            max_index=-(-mi // cfg.scale_y))
    elif dim < MAX_DIMS:
        r = scrambled_radical_inverse(indices, dim, perms, max_index=mi)
    else:
        salt = (0x9E3779B9 * (dim + 1) + cfg.seed) & 0xFFFFFFFF
        r = _hash_u32(indices, salt).astype(Float) * Float(2.0**-32)
    return jnp.minimum(r, ONE_MINUS_EPS)


def halton_sample_2d(indices, dim: int, cfg: HaltonConfig, perms):
    return jnp.stack(
        [
            halton_sample(indices, dim, cfg, perms),
            halton_sample(indices, dim + 1, cfg, perms),
        ],
        axis=-1,
    )
