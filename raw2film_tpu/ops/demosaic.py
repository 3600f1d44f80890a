"""Bayer demosaic on device: Malvar-He-Cutler 5x5 linear demosaic.

The reference delegates demosaic to LibRaw's PPG on the host
(reference: src/raw2film/raw_conversion.py:36-48). Here it runs on the
device as four fixed 5x5 shift-add convolutions + phase selects — pure
elementwise work that XLA fuses into one pass, no gathers, vectorized over
the whole frame (and batched under vmap).
Kernel coefficients are the published Malvar-He-Cutler (ICASSP 2004) ones.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from raw2film_tpu.ops import conv as convops

# --- MHC kernels, x1/8 ----------------------------------------------------
_G_AT_RB = (
    np.array(
        [
            [0, 0, -1, 0, 0],
            [0, 0, 2, 0, 0],
            [-1, 2, 4, 2, -1],
            [0, 0, 2, 0, 0],
            [0, 0, -1, 0, 0],
        ],
        np.float32,
    )
    / 8.0
)

_RB_AT_G_SAME_ROW = (
    np.array(
        [
            [0, 0, 0.5, 0, 0],
            [0, -1, 0, -1, 0],
            [-1, 4, 5, 4, -1],
            [0, -1, 0, -1, 0],
            [0, 0, 0.5, 0, 0],
        ],
        np.float32,
    )
    / 8.0
)

_RB_AT_G_SAME_COL = _RB_AT_G_SAME_ROW.T.copy()

_RB_AT_OPPOSITE = (
    np.array(
        [
            [0, 0, -1.5, 0, 0],
            [0, 2, 0, 2, 0],
            [-1.5, 0, 6, 0, -1.5],
            [0, 2, 0, 2, 0],
            [0, 0, -1.5, 0, 0],
        ],
        np.float32,
    )
    / 8.0
)

_PATTERNS = {
    "RGGB": (0, 0),
    "BGGR": (1, 1),
    "GRBG": (0, 1),
    "GBRG": (1, 0),
}


def _phase_masks(h: int, w: int, r_at: tuple[int, int]):
    """Boolean masks for the four Bayer phases given the R phase offset."""
    yy = jnp.arange(h)[:, None] & 1
    xx = jnp.arange(w)[None, :] & 1
    ry, rx = r_at
    r = (yy == ry) & (xx == rx)
    b = (yy == 1 - ry) & (xx == 1 - rx)
    g_r_row = (yy == ry) & (xx == 1 - rx)  # green sharing a row with red
    g_b_row = (yy == 1 - ry) & (xx == rx)
    return r, g_r_row, g_b_row, b


def demosaic_mhc(bayer: jnp.ndarray, pattern: str = "RGGB") -> jnp.ndarray:
    """bayer (H, W) float -> planar RGB (3, H, W)."""
    if pattern not in _PATTERNS:
        raise ValueError(f"unsupported Bayer pattern {pattern!r}")
    h, w = bayer.shape
    r_mask, grr, gbr, b_mask = _phase_masks(h, w, _PATTERNS[pattern])

    x = bayer[None]  # (1, H, W) single channel for conv
    conv = lambda k: convops.depthwise_conv2d(x, k)[0]

    g_interp = conv(_G_AT_RB)
    same_row = conv(_RB_AT_G_SAME_ROW)
    same_col = conv(_RB_AT_G_SAME_COL)
    opposite = conv(_RB_AT_OPPOSITE)

    g = jnp.where(r_mask | b_mask, g_interp, bayer)
    r = jnp.where(
        r_mask,
        bayer,
        jnp.where(grr, same_row, jnp.where(gbr, same_col, opposite)),
    )
    b = jnp.where(
        b_mask,
        bayer,
        jnp.where(gbr, same_row, jnp.where(grr, same_col, opposite)),
    )
    return jnp.stack([r, g, b])


def demosaic_exposure(
    bayer: jnp.ndarray, pattern: str, mat
) -> jnp.ndarray:
    """max(mat @ clip01(demosaic_mhc(bayer)), 0): demosaic fused with the
    chain's input transform. The 3x3 runs as exact-f32 scalar mul-adds
    (the same form as render._matp), so XLA fuses it into the demosaic's
    elementwise pass and the intermediate RGB image never reaches device
    memory; the result matches the staged formulation to f32 ulps (FMA
    contraction only)."""
    mat = jnp.asarray(mat, jnp.float32)
    rgb = jnp.clip(demosaic_mhc(bayer, pattern), 0.0, 1.0)
    p = (rgb[0], rgb[1], rgb[2])
    return jnp.stack(
        [
            jnp.maximum(
                mat[c, 0] * p[0] + mat[c, 1] * p[1] + mat[c, 2] * p[2], 0.0
            )
            for c in range(3)
        ]
    )


def demosaic_bilinear(bayer: jnp.ndarray, pattern: str = "RGGB") -> jnp.ndarray:
    """Cheap bilinear demosaic (preview / half-res substitutes)."""
    if pattern not in _PATTERNS:
        raise ValueError(f"unsupported Bayer pattern {pattern!r}")
    h, w = bayer.shape
    r_mask, grr, gbr, b_mask = _phase_masks(h, w, _PATTERNS[pattern])
    x = bayer[None]
    conv = lambda k: convops.depthwise_conv2d(x, np.asarray(k, np.float32))[0]
    kg = np.array([[0, 1, 0], [1, 4, 1], [0, 1, 0]], np.float32) / 4.0
    krb = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], np.float32) / 4.0
    g = jnp.where(r_mask | b_mask, conv(kg), bayer)
    r_plane = jnp.where(r_mask, bayer, 0.0)
    b_plane = jnp.where(b_mask, bayer, 0.0)
    r = jnp.where(r_mask, bayer, convops.depthwise_conv2d(r_plane[None], krb)[0])
    b = jnp.where(b_mask, bayer, convops.depthwise_conv2d(b_plane[None], krb)[0])
    return jnp.stack([r, g, b])


def demosaic_masked(
    mosaic: jnp.ndarray, pattern: str, tile_h: int, tile_w: int
) -> jnp.ndarray:
    """Generic masked demosaic for arbitrary CFA tilings — the X-Trans
    (6x6) path, in two classic stages:

    1. **Green plane** by masked interpolation (3x3 triangle over the dense
       G sites): g = conv(mosaic * mask_g) / conv(mask_g), measured values
       kept at G sites.
    2. **R/B by color-difference interpolation**: interpolate (R - G) /
       (B - G) from their sparse sites (5x5 triangle — the X-Trans layout
       guarantees an R/B site in every 5x5 window) and add G back. Chroma
       varies far more slowly than luminance, so this removes most of the
       zipper/desaturation error of direct channel interpolation while
       staying three depthwise convs + elementwise (XLA fuses the rest).

    Measured values are exact at every channel's own sites (the difference
    interpolation returns (C - G) + G = C there).
    """
    h, w = mosaic.shape
    code = {"R": 0, "G": 1, "B": 2}
    grid = np.array([code[c] for c in pattern], np.int32).reshape(
        tile_h, tile_w
    )
    reps = (-(-h // tile_h), -(-w // tile_w))
    full = np.tile(grid, reps)[:h, :w]
    masks = jnp.asarray(
        np.stack([(full == c) for c in range(3)]).astype(np.float32)
    )

    t3 = np.array([1.0, 2.0, 1.0], np.float32)
    t5 = np.array([1.0, 2.0, 3.0, 2.0, 1.0], np.float32)
    k3 = np.outer(t3, t3)
    k5 = np.outer(t5, t5)

    gm = masks[1:2]
    g_num = convops.depthwise_conv2d(mosaic[None] * gm, k3)
    g_den = convops.depthwise_conv2d(gm, k3)
    g = jnp.where(
        gm[0] > 0.5, mosaic, (g_num / jnp.maximum(g_den, 1e-8))[0]
    )

    rb_masks = jnp.stack([masks[0], masks[2]])
    diff = (mosaic - g)[None] * rb_masks
    d_num = convops.depthwise_conv2d(diff, np.stack([k5, k5]))
    d_den = convops.depthwise_conv2d(rb_masks, np.stack([k5, k5]))
    d = d_num / jnp.maximum(d_den, 1e-8)
    r = jnp.where(rb_masks[0] > 0.5, mosaic, g + d[0])
    b = jnp.where(rb_masks[1] > 0.5, mosaic, g + d[1])
    return jnp.stack([r, g, b])


def half_size_decode(bayer: jnp.ndarray, pattern: str = "RGGB") -> jnp.ndarray:
    """LibRaw half_size-style decode: each 2x2 cell -> one RGB pixel (greens
    averaged). Used for fast previews (reference: raw_conversion.py:33
    half_size=True default for preview)."""
    if pattern not in _PATTERNS:
        raise ValueError(f"unsupported Bayer pattern {pattern!r}")
    ry, rx = _PATTERNS[pattern]
    h2, w2 = bayer.shape[0] // 2, bayer.shape[1] // 2
    x = bayer[: h2 * 2, : w2 * 2]
    # Strided slices of one operand fuse into a single loop.
    r = x[ry::2, rx::2]
    b = x[1 - ry :: 2, 1 - rx :: 2]
    g = 0.5 * (x[ry::2, 1 - rx :: 2] + x[1 - ry :: 2, rx::2])
    return jnp.stack([r, g, b])
