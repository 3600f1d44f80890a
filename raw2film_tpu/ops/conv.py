"""Convolution primitives for planar (3, H, W) images.

Replaces the reference's OpenCV `cv.filter2D` dense convs
(reference: src/raw2film/effects.py:146-156) and its WGSL `convolution.wgsl`
GPU pass with static shift-and-add slices of one padded buffer (XLA fuses
them into a single elementwise loop), plus a host-side SVD factorization
that turns any small 2D kernel into a sum of separable row/column passes —
O(k) per pixel instead of O(k^2).

Boundary convention: 'reflect' (REFLECT_101), matching cv2.filter2D's default
border and scipy's 'mirror'.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

PAD_MODE = "reflect"



def _pad_hw(img: jnp.ndarray, ph: int, pw: int) -> jnp.ndarray:
    if ph == 0 and pw == 0:
        return img
    cfg = [(0, 0)] * (img.ndim - 2) + [(ph, ph), (pw, pw)]
    return jnp.pad(img, cfg, mode=PAD_MODE)


def depthwise_conv2d(img: jnp.ndarray, kernels: jnp.ndarray) -> jnp.ndarray:
    """Dense per-channel 2D convolution, shift-and-add formulation.

    img: (C, H, W); kernels: (C, kh, kw) or (kh, kw) shared across channels.
    Correlation orientation (matches cv2.filter2D / the reference shaders).
    Static shifted slices of one padded buffer fuse into a single
    elementwise pass; the taps are exact f32 (no matmul unit involved).
    """
    kernels = np.asarray(kernels)
    per_channel = kernels.ndim == 3
    kh, kw = kernels.shape[-2:]
    p = _pad_hw(img, kh // 2, kw // 2)
    h, w = img.shape[-2:]
    out = None
    for i in range(kh):
        for j in range(kw):
            kij = kernels[:, i, j] if per_channel else kernels[i, j]
            if per_channel:
                if not np.any(kij):
                    continue
                coef = jnp.asarray(kij, img.dtype).reshape(-1, 1, 1)
            else:
                if kij == 0.0:
                    continue
                coef = jnp.asarray(kij, img.dtype)
            term = coef * lax.slice(
                p, (0, i, j), (p.shape[0], i + h, j + w)
            )
            out = term if out is None else out + term
    return out if out is not None else jnp.zeros_like(img)


def _conv1d_axis(img: jnp.ndarray, k: np.ndarray, axis: int) -> jnp.ndarray:
    """Shift-and-add 1D correlation along H (axis=-2) or W (axis=-1).

    k: (taps,) shared or (C, taps) per-channel.
    """
    k = np.asarray(k)
    per_channel = k.ndim == 2
    taps = k.shape[-1]
    r = taps // 2
    if axis in (-2, img.ndim - 2):
        p = _pad_hw(img, r, 0)
    else:
        p = _pad_hw(img, 0, r)
    h, w = img.shape[-2:]
    out = None
    for i in range(taps):
        ki = k[:, i] if per_channel else k[i]
        if per_channel:
            coef = jnp.asarray(ki, img.dtype).reshape(-1, 1, 1)
        else:
            if ki == 0.0:
                continue
            coef = jnp.asarray(ki, img.dtype)
        if axis in (-2, img.ndim - 2):
            term = coef * lax.slice(p, (0, i, 0), (p.shape[0], i + h, w))
        else:
            term = coef * lax.slice(p, (0, 0, i), (p.shape[0], h, i + w))
        out = term if out is None else out + term
    return out if out is not None else jnp.zeros_like(img)


def separable_conv(img: jnp.ndarray, kv, kh) -> jnp.ndarray:
    """Separable conv: 1D kernel ``kv`` down columns then ``kh`` along rows.

    img: (C, H, W); kv: (C, k) or (k,); kh likewise. Host-side (numpy)
    kernels only — taps unroll into the kernel at trace time.
    """
    kv = np.asarray(kv)
    kh = np.asarray(kh)
    return _conv1d_axis(_conv1d_axis(img, kv, -2), kh, -1)


def svd_separable(kernel: np.ndarray, tol: float = 1e-4, max_rank: int = 6):
    """Host: factor a 2D kernel into separable rank-1 terms by SVD.

    Returns (U, V): U (r, kh) column kernels, V (r, kw) row kernels with
    kernel ~= sum_r outer(U[r], V[r]). Rank chosen so the spectral tail is
    below ``tol`` of the leading singular value.
    """
    u, s, vt = np.linalg.svd(np.asarray(kernel, np.float64))
    keep = max(1, int(np.sum(s > tol * s[0])))
    keep = min(keep, max_rank)
    scale = np.sqrt(s[:keep])
    return (
        (u[:, :keep] * scale).T.astype(np.float32),
        (vt[:keep] * scale[:, None]).astype(np.float32),
    )


def conv2d_svd(img: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Apply a host-factored kernel: sum of separable passes.

    u: (r, kh) or (C, r, kh) per-channel; v likewise (r, kw) / (C, r, kw).
    """
    u = np.asarray(u)
    v = np.asarray(v)
    per_channel = u.ndim == 3
    r = u.shape[-2]
    out = None
    for i in range(r):
        kv = u[:, i, :] if per_channel else u[i]
        kh = v[:, i, :] if per_channel else v[i]
        term = separable_conv(img, kv, kh)
        out = term if out is None else out + term
    return out


def gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """Host: scipy-compatible 1D Gaussian (radius = int(truncate*sigma+0.5))."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: jnp.ndarray, sigma: float, truncate: float = 4.0) -> jnp.ndarray:
    """Separable Gaussian blur with host-built kernel (static sigma)."""
    k = gaussian_kernel1d(sigma, truncate)
    return separable_conv(img, k, k)


def box_downsample(img: jnp.ndarray, factor: int) -> jnp.ndarray:
    """INTER_AREA-style integer-factor downsample: mean over factor x factor
    blocks (cv2 INTER_AREA equals block mean for integer factors,
    reference usage: src/raw2film/utils.py:232, effects.py:370).

    Implemented with lax.reduce_window pooling: strided-slice accumulation
    would need f^2 terms (f reaches 110 in the burn stage).
    """
    c, h, w = img.shape
    f = int(factor)
    h2, w2 = h // f, w // f
    x = img[:, : h2 * f, : w2 * f]

    def pool(t, win):
        return lax.reduce_window(
            t,
            jnp.zeros((), img.dtype),
            lax.add,
            window_dimensions=win,
            window_strides=win,
            padding="VALID",
        )

    # Two 1-D pools: O(f) adds per output instead of O(f^2).
    summed = pool(pool(x, (1, f, 1)), (1, 1, f))
    return summed * (1.0 / (f * f))


def bilinear_upsample(img: jnp.ndarray, out_hw: tuple[int, int]) -> jnp.ndarray:
    """Bilinear resize up (align-corners=False, half-pixel centers)."""
    return jax.image.resize(img, (img.shape[0], *out_hw), method="bilinear")


def zoom_upsample(img: jnp.ndarray, factor: int, out_hw: tuple[int, int]) -> jnp.ndarray:
    """scipy.ndimage.zoom(order=1)-compatible integer upsample then edge-pad /
    crop to ``out_hw`` (reference: src/raw2film/effects.py:381-385)."""
    c, h, w = img.shape
    # ndimage.zoom with order=1 maps output grid to input via
    # in = out * (in_size-1)/(out_size-1) (align-corners style).
    oh, ow = h * factor, w * factor
    up = jax.image.resize(img, (c, oh, ow), method="linear")
    # jax linear resize uses half-pixel centers; difference from ndimage.zoom
    # is sub-pixel at the borders of a low-res mask that then gets cropped —
    # acceptable for the burn stage it serves.
    ph = max(out_hw[0] - oh, 0)
    pw = max(out_hw[1] - ow, 0)
    if ph or pw:
        up = jnp.pad(up, [(0, 0), (0, ph), (0, pw)], mode="edge")
    return up[:, : out_hw[0], : out_hw[1]]
