"""Device grain synthesis: stateless hash noise -> correlation conv -> amplitude.

Reference pipeline: Gaussian noise (PCG hash + Box-Muller, fresh seed every
render — shaders/noise.wgsl, gpu_processor.py:586-591), convolved with a
grain correlation kernel, scaled by a density-dependent amplitude LUT and
added to the density image (shaders/grain.wgsl).

Differences from the reference:
* deterministic: the noise is a positionally-stateless PCG-3D hash of
  (x, y, seed ^ channel), so a render is reproducible per seed and the
  field does not depend on tiling or row sharding (the reference GPU path
  is intentionally not reproducible);
* the amplitude is evaluated analytically from the stock's GrainModel
  (no LUT gather);
* the correlation conv is separable (the kernel is an isotropic Gaussian).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.lax import bitcast_convert_type as _bitcast

from raw2film_tpu.film.grain import ISO_APERTURE_UM
from raw2film_tpu.ops import fastmath as fm


def _pcg3d(x, y, z):
    """PCG-3D hash (Jarzynski & Olano), uint32 in/out."""
    v0 = x * np.uint32(1664525) + np.uint32(1013904223)
    v1 = y * np.uint32(1664525) + np.uint32(1013904223)
    v2 = z * np.uint32(1664525) + np.uint32(1013904223)
    v0 = v0 + v1 * v2
    v1 = v1 + v2 * v0
    v2 = v2 + v0 * v1
    v0 = v0 ^ (v0 >> np.uint32(16))
    v1 = v1 ^ (v1 >> np.uint32(16))
    v2 = v2 ^ (v2 >> np.uint32(16))
    v0 = v0 + v1 * v2
    v1 = v1 + v2 * v0
    v2 = v2 + v0 * v1
    return v0, v1, v2


def _popcount(v):
    """SWAR popcount, uint32 -> uint32 in [0, 32]."""
    v = v - ((v >> np.uint32(1)) & np.uint32(0x55555555))
    v = (v & np.uint32(0x33333333)) + ((v >> np.uint32(2)) & np.uint32(0x33333333))
    v = (v + (v >> np.uint32(4))) & np.uint32(0x0F0F0F0F)
    return (v * np.uint32(0x01010101)) >> np.uint32(24)


def _gauss_pair(u_bits, v_bits):
    """Standard normal from two uint32 hash words via bit-sum binomial:
    popcount(u) + popcount(v) ~ Binomial(64, 1/2) -> (S - 32) / 4.

    Exactly unit variance, excess kurtosis -0.031 (within the grain field's
    |k|<0.1 contract), support +-8 sigma, and a few integer ops per word
    where Box-Muller costs log+sqrt+cos. Film grain is blind to the
    65-level quantization: the correlation kernel and the amplitude curve
    smooth it, and real grain is binary clumps anyway.
    """
    s = _popcount(u_bits) + _popcount(v_bits)
    # Values 0..64: the int32 view is exact.
    return (_bitcast(s, jnp.int32).astype(jnp.float32) - np.float32(32.0)) * np.float32(
        0.25
    )


def seed2(seed, row_off=0) -> jnp.ndarray:
    """Normalize to the uint32 pair [seed, global_row_offset] the grain
    field consumes. Accepts python ints, 0-d/1-d arrays; a (2,) array
    passes through. row_off may be a traced int (space sharding)."""
    if isinstance(seed, jnp.ndarray) and seed.shape == (2,):
        return seed.astype(jnp.uint32)
    s = jnp.asarray(seed, jnp.uint32).reshape(-1)[0]
    r = jnp.asarray(row_off, jnp.int32).astype(jnp.uint32).reshape(())
    return jnp.stack([s, r])


def grain_corr_taps(sigma_px: float) -> tuple:
    """Host: L2-normalized correlation taps (separable pass applied twice
    keeps the field at unit variance). sigma_px < 0.3 -> white noise."""
    if sigma_px >= 0.3:
        from raw2film_tpu.ops.conv import gaussian_kernel1d

        k = gaussian_kernel1d(sigma_px, truncate=2.5).astype(np.float64)
        k = k / np.linalg.norm(k)
    else:
        k = np.ones(1, np.float64)
    return tuple(float(t) for t in k)


def grain_field_hash(seed, hw: tuple, sigma_px: float, bw: bool = False):
    """(3, H, W) correlated unit-variance grain field from the
    positionally-stateless PCG-3D + popcount-binomial hash: the noise
    sample at output (y, x) and tap (qy, qx) has hash coordinates
    (y + qy, x + qx + seed[1] rows), so any tiling or row sharding of the
    frame reproduces the identical field. ``seed`` is a seed2 pair; its
    second word is the global row of local row 0 (mod-2^32 add, so a
    negative offset wraps harmlessly). ``bw`` shares one field across the
    three channels."""
    h, w = hw
    taps = grain_corr_taps(sigma_px)
    r = len(taps) // 2
    c = 1 if bw else 3
    sd = seed2(seed)
    eh, ew = h + 2 * r, w + 2 * r
    yy_i = jax.lax.broadcasted_iota(jnp.int32, (c, eh, ew), 1)
    xx_i = jax.lax.broadcasted_iota(jnp.int32, (c, eh, ew), 2)
    ch = jax.lax.broadcasted_iota(jnp.int32, (c, eh, ew), 0)
    # 0x9E3779B9 as a signed 32-bit literal: -1640531527.
    z_i = ch * np.int32(-1640531527) if not bw else jnp.zeros_like(ch)
    a, b, _ = _pcg3d(
        _bitcast(xx_i, jnp.uint32),
        _bitcast(yy_i, jnp.uint32) + sd[1],
        _bitcast(z_i, jnp.uint32) + sd[0],
    )
    noise = _gauss_pair(a, b)
    col = None
    for q in range(len(taps)):
        term = taps[q] * noise[:, q : q + h, :]
        col = term if col is None else col + term
    field = None
    for q in range(len(taps)):
        term = taps[q] * col[:, :, q : q + w]
        field = term if field is None else field + term
    if bw:
        field = jnp.broadcast_to(field, (3, h, w))
    return field


def correlation_sigma_px(
    scale: float, grain_size_mm: float, grain_sigma: float
) -> float:
    return grain_size_mm * scale * grain_sigma


def generate_grain_field(
    key: jax.Array,
    hw: tuple[int, int],
    scale: float,
    grain_size_mm: float = 0.006,
    grain_sigma: float = 0.4,
    bw: bool = False,
    row_offset=0,
) -> jnp.ndarray:
    """Unit-variance correlated grain field, planar (3, H, W), deterministic
    per (key, position). ``row_offset`` shifts the hash rows to GLOBAL image
    coordinates for space-sharded renders."""
    sigma_px = correlation_sigma_px(scale, grain_size_mm, grain_sigma)
    sd = seed2((key[0] ^ key[1]).astype(jnp.uint32), row_offset)
    return grain_field_hash(sd, hw, sigma_px, bw=bw)


def grain_amplitude_device(
    density: jnp.ndarray,
    rms: float,
    d_lo: float,
    d_hi: float,
    scale: float,
    peak_density: float,
    width: float,
    floor: float,
    bw_grain: bool = False,
) -> jnp.ndarray:
    """jnp mirror of GrainModel.amplitude * pixel_rms_scale
    (:mod:`raw2film_tpu.film.grain`)."""
    rng = max(float(d_hi - d_lo), 1e-3)
    t = (density - d_lo) / rng
    shape = floor + (1 - floor) * fm.expe(
        -0.5 * ((t - peak_density / rng * 0.5 - 0.25) / (width * 0.35)) ** 2
    )
    pixel_um = 1000.0 / scale
    amp = (rms / 1000.0) * shape * (ISO_APERTURE_UM / pixel_um)
    if bw_grain:
        amp = jnp.broadcast_to(amp.mean(axis=0, keepdims=True), amp.shape)
    return amp


def apply_grain(
    density: jnp.ndarray,
    key: jax.Array,
    stock,
    scale: float,
    grain_size_mm: float = 0.006,
    grain_sigma: float = 0.4,
    bw_grain: bool = False,
) -> jnp.ndarray:
    """density (3,H,W) + amplitude(density) * field; clipped at 0 after
    (reference: src/raw2film/cpu_processor.py:387-397)."""
    gm = stock.grain
    if gm is None:
        return density
    d_min, *_ = stock.curve.params()
    lo = float(np.min(d_min))
    hi = float(np.max(stock.curve.d_max))
    if hi < lo:
        lo, hi = hi, lo
    field = generate_grain_field(
        key, density.shape[-2:], scale, grain_size_mm, grain_sigma, bw=bw_grain
    )
    amp = grain_amplitude_device(
        density, gm.rms, lo, hi, scale, gm.peak_density, gm.width, gm.floor,
        bw_grain=bw_grain,
    )
    return jnp.maximum(density + amp * field, 0.0)
