"""RGB histogram: device binning (one-hot matmul), host strip rasterization.

Reference: 256-bin counts -> log1p normalize -> 3-tap smooth -> render to an
RGBA strip via a precomputed 2x2x2 additive mix table (reference:
src/raw2film/utils.py:93-223, shaders/histogram.wgsl). The counting runs on
device without scatters: bincount as a sum over a one-hot comparison.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

# A 256-bin log-normalized UI strip needs ~thousands of samples per bin at
# most; beyond this, extra pixels change nothing visible. Bounding the
# sample count keeps the one-hot reduction's working set fixed regardless of
# export size (a full 45MP one-hot would be ~138GB notional).
MAX_SAMPLES = 1 << 19
_BLOCK = 1 << 14


@partial(jax.jit, static_argnames=("stride",))
def _counts_jit(img_u8: jnp.ndarray, stride: int) -> jnp.ndarray:
    flat = img_u8[:, ::stride, ::stride].reshape(3, -1).astype(jnp.int32)
    p = flat.shape[1]
    pb = -(-p // _BLOCK) * _BLOCK
    # Pad with -1: matches no bin, so padding never pollutes counts.
    flat = jnp.pad(flat, ((0, 0), (0, pb - p)), constant_values=-1)
    blocks = flat.reshape(3, -1, _BLOCK).transpose(1, 0, 2)  # (nb, 3, B)
    iota = jnp.arange(256, dtype=jnp.int32)

    def body(xb):  # (3, B) -> (3, 256); peak temp 3*B*256 f32 = 48MB
        return (xb[..., None] == iota).astype(jnp.float32).sum(axis=1)

    per_block = jax.lax.map(body, blocks)
    return per_block.sum(axis=0) * float(stride * stride)


def histogram_counts(img_u8: jnp.ndarray) -> jnp.ndarray:
    """img_u8 (3, H, W) uint8 -> (3, 256) float32 counts (scatter-free).

    Images beyond MAX_SAMPLES pixels are stride-subsampled and the counts
    rescaled; exact below that. Working memory is bounded (~48MB) at every
    image size.
    """
    h, w = img_u8.shape[-2:]
    stride = int(np.ceil(np.sqrt(max(h * w / MAX_SAMPLES, 1.0))))
    return _counts_jit(img_u8, stride)


def precompute_mix_table(
    red=None, green=None, blue=None
) -> np.ndarray:
    """(2, 2, 2, 4) uint8 additive-blend table (linear-light mixing)."""
    if red is None:
        # Perceptually-tuned channel hues (sRGB 8-bit).
        red = np.array([235.0, 90.0, 80.0])
        green = np.array([80.0, 200.0, 90.0])
        blue = np.array([95.0, 110.0, 235.0])
    lin = [np.asarray(c, np.float32) / 255.0 for c in (red, green, blue)]
    lin = [c**2.2 for c in lin]
    table = np.zeros((2, 2, 2, 4), np.uint8)
    for r in (0, 1):
        for g in (0, 1):
            for b in (0, 1):
                if not (r or g or b):
                    continue
                mix = np.clip(r * lin[0] + g * lin[1] + b * lin[2], 0, 1)
                table[r, g, b, :3] = np.round(mix ** (1 / 2.2) * 255)
                table[r, g, b, 3] = 255
    peak = (table[1, 1, 1, :3] / 255.0) ** 2.2
    table[1, 1, 1, :3] = int(round(peak.mean() ** (1 / 2.2) * 255))
    return table


MIX_TABLE = precompute_mix_table()


def render_histogram(
    counts: np.ndarray, height: int = 100, mix_table: np.ndarray = MIX_TABLE
) -> np.ndarray:
    """(3, 256) counts -> (height, 256, 4) uint8 strip (host; tiny)."""
    c = np.asarray(counts, np.float32)
    mx = max(float(c.max()), 1.0)
    f = np.log1p(c / mx)
    sm = np.empty_like(f)
    sm[:, 1:-1] = (f[:, :-2] + f[:, 1:-1] + f[:, 2:]) / 3
    sm[:, 0] = (2 * f[:, 0] + f[:, 1]) / 3
    sm[:, -1] = (2 * f[:, -1] + f[:, -2]) / 3
    mx2 = max(float(sm.max()), 1e-9)
    bars = (sm * height / mx2).astype(np.int32)  # (3, 256)
    rows = np.arange(height)[:, None]
    act = (rows >= (height - bars[:, None, :])).astype(np.int32)  # (3, H, 256)
    return mix_table[act[0], act[1], act[2]]


def generate_histogram(img_u8, height: int = 100) -> np.ndarray:
    """Full pipeline: device counts + host strip."""
    counts = np.asarray(histogram_counts(jnp.asarray(img_u8)))
    return render_histogram(counts, height)


def scale_strip(strip: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Nearest-neighbor scale of the histogram strip onto a UI canvas
    (role of reference shaders/scale_texture.wgsl)."""
    h, w = strip.shape[:2]
    ys = (np.arange(out_h) * h // out_h).clip(0, h - 1)
    xs = (np.arange(out_w) * w // out_w).clip(0, w - 1)
    return strip[ys][:, xs]
