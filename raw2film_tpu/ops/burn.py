"""Highlight burn: local tone-mapping on density.

Reference: ``img -= hb * down_up_blur(max(green - d_ref, 0))`` where
down_up_blur = INTER_AREA downsample by ceil(min(H,W)/burn_scale) ->
Gaussian sigma=3 truncate=2 -> bilinear upsample (reference:
src/raw2film/effects.py:360-418, shaders/highlight_burn.wgsl).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from raw2film_tpu.ops import conv as convops


def _aligned_slice(mask: jnp.ndarray, factor: int, row_offset) -> tuple:
    """Slice rows of a local (1, H, W) shard so the box-downsample cells land
    on the GLOBAL grid: cell boundaries at global rows k*factor regardless of
    where this shard starts. ``row_offset`` (traced ok) is the global row of
    local row 0. Returns (sliced rows, q, hs) where q is the local row of the
    first global cell boundary and hs the static worst-case cell count."""
    h = mask.shape[-2]
    hs = (h - (factor - 1)) // factor
    q = jnp.mod(-jnp.asarray(row_offset, jnp.int32), factor)
    sliced = jax.lax.dynamic_slice_in_dim(mask, q, hs * factor, axis=-2)
    return sliced, q, hs


def _lerp_rows_dynamic(h: int, hs: int, factor: int, q) -> jnp.ndarray:
    """(h, hs) half-pixel bilinear upsample weights whose cell grid starts at
    traced local row ``q`` (half-pixel hat weights + edge clamp)."""
    rel = (jnp.arange(h, dtype=jnp.float32) - q + 0.5) / factor - 0.5
    rel = jnp.clip(rel, 0.0, hs - 1.0)
    return jnp.maximum(
        0.0, 1.0 - jnp.abs(rel[:, None] - jnp.arange(hs, dtype=jnp.float32)[None, :])
    )


def down_up_blur(
    mask: jnp.ndarray, burn_scale: float = 50.0, factor: int | None = None
) -> jnp.ndarray:
    """(1, H, W) -> (1, H, W): area-downsample (reduce_window), sigma=3
    trunc=2 blur, bilinear upsample, edge-padded to the full frame."""
    h, w = mask.shape[-2:]
    if factor is None:
        factor = max(1, math.ceil(min(h, w) / burn_scale))
    small = convops.box_downsample(mask, factor)
    blurred = convops.gaussian_blur(small, 3.0, truncate=2.0)
    return convops.zoom_upsample(blurred, factor, (h, w))


def burn(
    density: jnp.ndarray,
    d_ref_green: float,
    highlight_burn: float,
    burn_scale: float = 50.0,
    ref_hw: tuple | None = None,
    row_offset=None,
) -> jnp.ndarray:
    """Apply highlight burn to a density-domain planar image (3, H, W).

    Uses the green channel (or the single channel for BW) as the luminance
    proxy, like the reference (src/raw2film/effects.py:411-414).
    ``ref_hw`` overrides the dimensions the blur factor derives from —
    space-sharded renders pass the GLOBAL frame size so every shard uses
    the single-device factor; ``row_offset`` additionally aligns the
    low-res grid to the global frame, so every shard computes the same
    glow values for the same global cells and seams carry no one-cell
    misalignment (parallel/mesh.py halo path).
    """
    g = density[1:2]
    mask = jnp.maximum(g - d_ref_green, 0.0)
    rh, rw = ref_hw if ref_hw is not None else density.shape[-2:]
    factor = max(1, math.ceil(min(int(rh), int(rw)) / burn_scale))
    h, w = density.shape[-2:]
    if row_offset is not None and factor > 1 and (h - (factor - 1)) // factor > 0:
        sliced, q, hs = _aligned_slice(mask, factor, row_offset)
        ws = max(w // factor, 1)
        small = convops.gaussian_blur(
            convops.box_downsample(sliced, factor), 3.0, truncate=2.0
        )
        rm = _lerp_rows_dynamic(h, hs, factor, q)
        cm = _lerp_rows_dynamic(w, ws, factor, jnp.zeros((), jnp.int32))
        hi = jax.lax.Precision.HIGHEST
        t = jnp.einsum("Oh,chw->cOw", rm, small, precision=hi)
        blur = jnp.einsum("cOw,Ww->cOW", t, cm, precision=hi)
    else:
        blur = down_up_blur(mask, burn_scale, factor=factor)
    return jnp.maximum(density - highlight_burn * blur, 0.0)
