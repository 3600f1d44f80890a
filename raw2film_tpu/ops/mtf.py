"""Film MTF sharpness: frequency-domain transfer function -> spatial conv.

Mirrors the reference's construction (radial MTF response on the FFT
frequency grid, inverse FFT, fftshift-center, normalize — reference:
src/raw2film/effects.py:114-197) including the optional unsharp-mask term
baked into the kernel, then applies it on device as SVD-separable passes
(the kernel is radially symmetric, so a handful of separable ranks capture
it to ~1e-4).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax.numpy as jnp

from scipy import ndimage

from raw2film_tpu.ops import conv as convops

KERNEL_SIZE_MM = 0.1  # spatial support of the MTF kernel (reference: effects.py:161)


def mtf_kernel_layer(
    logf: np.ndarray, vals: np.ndarray, scale: float, signed: bool = False
) -> np.ndarray:
    """Host: one channel's spatial kernel from tabulated (log1p f, MTF).

    ``signed=False`` reproduces the reference construction exactly,
    including its np.abs() rectification of the inverse FFT (reference:
    src/raw2film/effects.py:139-141) — which destroys the negative lobes
    the adjacency-effect bump needs and softens the kernel's measured
    MTF-50 to 0.45-0.85 of the tabulated figure (pinned in
    tests/test_film_science.py::TestDatasheetAnchors). ``signed=True`` is
    the r2f fidelity mode (``mtf_fidelity`` param): keep the real part's
    sign so the built kernel's response tracks the tabulated curve."""
    pixel_size_mm = 1.0 / scale
    n = round(KERNEL_SIZE_MM / pixel_size_mm)
    if n % 2 == 0:
        n += 1
    n = max(n, 3)
    fx = np.fft.fftfreq(n, d=pixel_size_mm)
    f = np.sqrt(fx[:, None] ** 2 + fx[None, :] ** 2)
    h = np.interp(np.log1p(f), logf, vals, left=1.0, right=0.0)
    ks = np.fft.ifft2(h).real
    k = np.fft.fftshift(ks if signed else np.abs(ks))
    return (k / k.sum()).astype(np.float32)


@lru_cache(maxsize=50)
def mtf_kernel(
    mtf_key,  # hashable: tuple of per-channel (tuple(logf), tuple(vals))
    scale: float,
    sharpening_strength: float = 0.0,
    sharpening_sigma: float = 1.0,
    signed: bool = False,
) -> np.ndarray:
    """Host: stacked (3, k, k) kernel, with optional unsharp boost
    k += strength * (k - gauss(k, sigma*scale/50)) (reference:
    src/raw2film/effects.py:179-184)."""
    layers = [
        mtf_kernel_layer(np.asarray(lf), np.asarray(v), scale, signed=signed)
        for lf, v in mtf_key
    ]
    if len(layers) == 1:
        layers = layers * 3
    k = np.stack(layers).astype(np.float32)
    if sharpening_strength:
        sigma = sharpening_sigma * scale / 50.0
        blurred = np.stack([ndimage.gaussian_filter(ki, sigma=sigma) for ki in k])
        k = k + np.float32(sharpening_strength) * (k - blurred)
    return k


def _hashable_mtf(mtf) -> tuple:
    return tuple((tuple(map(float, lf)), tuple(map(float, v))) for lf, v in mtf)


def film_sharpness(
    img: jnp.ndarray,
    mtf,
    scale: float,
    sharpening_strength: float = 0.0,
    sharpening_sigma: float = 1.0,
    signed: bool = False,
) -> jnp.ndarray:
    """Device: apply the per-channel MTF kernel to a density-domain image."""
    return film_sharpness_from_key(
        img, _hashable_mtf(mtf), scale, sharpening_strength, sharpening_sigma,
        signed=signed,
    )


def _svd_stack(k: np.ndarray, tol: float, max_rank: int):
    """Per-channel SVD factorization padded to a common rank."""
    us, vs = [], []
    rank = 0
    for c in range(3):
        u, v = convops.svd_separable(k[c], tol=tol, max_rank=max_rank)
        us.append(u)
        vs.append(v)
        rank = max(rank, u.shape[0])
    u3 = np.zeros((3, rank, k.shape[-2]), np.float32)
    v3 = np.zeros((3, rank, k.shape[-1]), np.float32)
    for c in range(3):
        u3[c, : us[c].shape[0]] = us[c]
        v3[c, : vs[c].shape[0]] = vs[c]
    return u3, v3


def film_sharpness_from_key(
    img: jnp.ndarray,
    mtf_key: tuple,
    scale: float,
    sharpening_strength: float = 0.0,
    sharpening_sigma: float = 1.0,
    signed: bool = False,
) -> jnp.ndarray:
    """Same, taking the pre-hashed MTF tabulation (jit-static friendly)."""
    k = mtf_kernel(
        mtf_key, float(scale), float(sharpening_strength),
        float(sharpening_sigma), signed=signed,
    )
    if k.shape[-1] <= 15:
        return convops.depthwise_conv2d(img, k)
    u3, v3 = _svd_stack(k, tol=2e-3, max_rank=4)
    return convops.conv2d_svd(img, u3, v3)
