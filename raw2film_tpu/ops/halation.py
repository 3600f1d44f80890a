"""Halation: red-dominant glow around highlights.

The reference convolves the linear-exposure image with an exponential-falloff
kernel of radius ``scale/4 * halation_size`` px (~0.25 mm) with per-channel
color factors, normalized so the image mean is preserved:
``out = (img + f_c * blur(img)) / (1 + f_c)``
(reference: src/raw2film/effects.py:200-287).

Design: the kernel radius grows with export scale (>100 px at 400 px/mm),
so a dense conv costs O(r^2) per pixel. Instead the exact kernel is fitted (host, least-squares on radial profiles)
with a small sum of isotropic Gaussians; each Gaussian is applied as a
separable conv — wide ones on a box-downsampled pyramid level, which is
accurate because a >30 px Gaussian has no content above the Nyquist of a
4x-decimated grid. Fit residual is checked by tests (<2% of kernel mass).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax.numpy as jnp

from raw2film_tpu.ops import conv as convops


def exponential_blur_kernel(size: float) -> np.ndarray:
    """Host: the exact halation kernel — (1/d^2) * max((r - d)/r, 0), center
    weight 1, normalized (reference: src/raw2film/effects.py:200-217)."""
    radius = size / 2.0
    n = 2 * int(np.floor(np.ceil(size) / 2)) + 1
    center = np.ceil(n / 2.0)
    ii = np.arange(1, n + 1, dtype=np.float64)
    di = (ii - center) ** 2
    dist = di[:, None] + di[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        k = np.where(
            dist == 0.0,
            1.0,
            (1.0 / dist) * np.maximum((radius - np.sqrt(dist)) / radius, 0.0),
        )
    return k / k.sum()


INNER_RADIUS = 5  # dense correction window half-size (11x11)


@lru_cache(maxsize=32)
def fit_gaussian_mixture(size: float, n_terms: int = 5):
    """Host: factor the exact kernel as

        k = inner_correction (dense, 11x11)  +  sum_i w_i * Gaussian(sigma_i)

    The Gaussians are least-squares fitted to the full kernel; whatever they
    miss inside the 11x11 core (the 1/d^2 spike lives there) goes verbatim
    into the dense correction, so the only approximation error is the smooth
    outer tail. Returns (sigmas, weights, inner (11,11), residual_l1 over the
    outer region).
    """
    k = exponential_blur_kernel(size)
    n = k.shape[0]
    c = n // 2
    yy, xx = np.mgrid[0:n, 0:n]
    r2 = (yy - c) ** 2.0 + (xx - c) ** 2.0
    radius = max(size / 2.0, 1.0)
    sigmas = np.geomspace(max(1.2, radius / 30.0), radius / 1.7, n_terms)
    basis = np.stack(
        [np.exp(-0.5 * r2 / s**2) / (2 * np.pi * s**2) for s in sigmas], axis=-1
    )
    a = basis.reshape(-1, n_terms)
    # Fit the tail only (core handled exactly by the correction kernel).
    outer = (r2 > INNER_RADIUS**2).ravel()
    w, *_ = np.linalg.lstsq(a[outer], k.ravel()[outer], rcond=None)
    w = np.maximum(w, 0.0)
    recon = (a @ w).reshape(n, n)
    resid_outer = float(np.abs(recon - k)[r2 > INNER_RADIUS**2].sum())
    inner = np.zeros((2 * INNER_RADIUS + 1,) * 2, np.float64)
    lo_src = max(c - INNER_RADIUS, 0)
    hi_src = min(c + INNER_RADIUS + 1, n)
    lo_dst = lo_src - (c - INNER_RADIUS)
    patch = (k - recon)[lo_src:hi_src, lo_src:hi_src]
    inner[lo_dst : lo_dst + patch.shape[0], lo_dst : lo_dst + patch.shape[1]] = patch
    return (
        tuple(float(s) for s in sigmas),
        tuple(float(x) for x in w),
        inner.astype(np.float32),
        resid_outer,
    )


PYRAMID_SIGMA = 8.0  # sigmas above this run on a decimated level


def _pyramid_factor(sigma: float) -> int:
    """Decimation of the pyramid level a Gaussian of ``sigma`` runs on."""
    return 4 if sigma <= 48.0 else 8


def _pyramid_blur(img: jnp.ndarray, factor: int, terms) -> jnp.ndarray:
    """sum_i w_i * Gaussian(sigma_i) for the (sigma, w) ``terms`` of one
    decimation factor: ONE box-downsampled level shared by the terms, the
    weighted blurs summed there, ONE bilinear upsample back (standard
    fast-glow; linear, so equal to upsampling each term). A sigma > 2.5
    Gaussian has negligible content above the Nyquist of a 2x-decimated
    grid, so each tier is accurate to <1% of the term's mass."""
    small = convops.box_downsample(img, factor)
    acc = None
    for s, w in terms:
        term = w * convops.gaussian_blur(small, s / factor, truncate=3.0)
        acc = term if acc is None else acc + term
    return convops.bilinear_upsample(acc, img.shape[-2:])


def halation_blur(
    img: jnp.ndarray, scale: float, halation_size: float, exact: bool = False
) -> jnp.ndarray:
    """The glow term alone (callers fuse the combine into their elementwise
    chain): blur(img) with the exponential halation kernel."""
    size = scale / 4.0 * halation_size
    if exact or size <= 12.0:
        k = exponential_blur_kernel(size).astype(np.float32)
        return convops.depthwise_conv2d(img, k)
    if size <= 40.0:
        u, v = convops.svd_separable(
            exponential_blur_kernel(size).astype(np.float32), tol=1e-4, max_rank=8
        )
        return convops.conv2d_svd(img, u, v)
    sigmas, weights, inner, _ = fit_gaussian_mixture(size)
    blur = convops.depthwise_conv2d(img, inner)
    by_factor: dict = {}
    for s, w in zip(sigmas, weights):
        if w <= 1e-6:
            continue
        if s <= PYRAMID_SIGMA:
            blur = blur + w * convops.gaussian_blur(img, s, truncate=3.0)
        else:
            by_factor.setdefault(_pyramid_factor(s), []).append((s, w))
    for factor, terms in by_factor.items():
        blur = blur + _pyramid_blur(img, factor, terms)
    return blur


def halation_with_factors(
    img: jnp.ndarray,
    scale: float,
    halation_size: float,
    factors: jnp.ndarray,
    exact: bool = False,
) -> jnp.ndarray:
    """Core halation apply with *traced* per-channel color factors (3, 1, 1)
    so intensity/green-factor sliders never retrigger compilation; only the
    kernel geometry (scale, halation_size) is static."""
    blur = halation_blur(img, scale, halation_size, exact=exact)
    return (img + factors * blur) / (1.0 + factors)


def halation(
    img: jnp.ndarray,
    scale: float,
    halation_size: float = 1.0,
    halation_red_factor: float = 1.0,
    # 0.4 here vs 0.3 in pipeline/params.py is reference-faithful, not a
    # drift: the reference's op-level default is 0.4 (effects.py:243) while
    # its settings schema ships 0.3 (gui.py:500) — users get 0.3, direct
    # op callers get 0.4, exactly as upstream.
    halation_green_factor: float = 0.4,
    halation_blue_factor: float = 0.0,
    halation_intensity: float = 1.0,
    bw: bool = False,
    exact: bool = False,
) -> jnp.ndarray:
    """Device: apply halation to a linear-exposure planar image (3, H, W).

    ``exact=True`` uses the dense kernel (for small scales / validation);
    default is the Gaussian-mixture pyramid path.
    """
    if bw:
        halation_red_factor = halation_green_factor
        halation_blue_factor = halation_green_factor
    factors = halation_intensity * jnp.asarray(
        [halation_red_factor, halation_green_factor, halation_blue_factor],
        img.dtype,
    ).reshape(3, 1, 1)
    return halation_with_factors(img, scale, halation_size, factors, exact=exact)
