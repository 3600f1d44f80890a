"""RAW -> linear CIE XYZ: the decode front of the pipeline.

Equivalent of the reference's ``raw_to_linear`` (LibRaw demosaic to 16-bit
linear XYZ + auto exposure, reference: src/raw2film/raw_conversion.py:33-53),
but device-first: the container parse stays on host
(:mod:`raw2film_tpu.io.dng`), demosaic / color matrix / exposure scaling run
on device as convs + matmuls.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import jax.numpy as jnp

from raw2film_tpu.io.dng import RawImage, read_raw
from raw2film_tpu.ops import demosaic as dm


def calc_exposure(
    xyz: np.ndarray,
    ref_exposure: float = 0.18,
    metadata: dict | None = None,
    subsampled: bool = False,
) -> float:
    """Stops of gain needed to bring the image to mid-grey.

    Same estimator family as the reference (power-mean of the 2x-subsampled
    green channel with an EXIF-derived exponent,
    reference: src/raw2film/color_processing.py:71-99). ``subsampled=True``
    means the caller already extracted the 2x-subsampled green plane
    (device-side slicing avoids fetching the full frame for this scalar).
    """
    lum = np.asarray(xyz) if subsampled else np.asarray(xyz)[1, ::2, ::2]
    factor = 3.0
    if metadata:
        try:
            fn = float(metadata.get("EXIF:FNumber") or 4.0)
            iso = float(metadata["EXIF:ISO"])
            t = float(metadata["EXIF:ExposureTime"])
            factor = math.sqrt(fn**2 / iso / t) + 1.0
        except (KeyError, TypeError, ValueError, ZeroDivisionError):
            factor = 3.0
    lum = np.maximum(lum, 1e-9)
    avg = float(np.mean(lum ** (1.0 / factor)) ** factor)
    return math.log2(ref_exposure / max(avg, 1e-9))


def apply_orientation(rgb: jnp.ndarray, orientation: int) -> jnp.ndarray:
    """Upright a planar (3, H, W) image per TIFF tag 274 (the reference gets
    this from LibRaw's postprocess). Runs once per decode on device."""
    o = int(orientation)
    if o == 2:  # top-right: mirror horizontal
        return rgb[:, :, ::-1]
    if o == 3:  # bottom-right: rotate 180
        return rgb[:, ::-1, ::-1]
    if o == 4:  # bottom-left: mirror vertical
        return rgb[:, ::-1, :]
    if o == 5:  # left-top: transpose
        return jnp.transpose(rgb, (0, 2, 1))
    if o == 6:  # right-top: rotate 90 CW
        return jnp.rot90(rgb, k=-1, axes=(1, 2))
    if o == 7:  # right-bottom: transverse
        return jnp.transpose(rgb, (0, 2, 1))[:, ::-1, ::-1]
    if o == 8:  # left-bottom: rotate 90 CCW
        return jnp.rot90(rgb, k=1, axes=(1, 2))
    return rgb


def decode_raw(
    raw: RawImage, half_size: bool = False, demosaic: str = "mhc"
) -> jnp.ndarray:
    """RawImage -> device planar (3, H, W) float32 camera-linear XYZ in [0~1],
    uprighted per the container's Orientation tag."""
    data = jnp.asarray(raw.data)
    norm = 1.0 / max(raw.white_level - raw.black_level, 1.0)
    if raw.cfa_pattern is not None:
        mosaic = (data - raw.black_level) * norm
        mosaic = jnp.clip(mosaic, 0.0, 1.0)
        if len(raw.cfa_pattern) == 36:
            # X-Trans (6x6): generic masked-interpolation demosaic; the
            # half-size preview is the same decode box-averaged 2x2.
            rgb = dm.demosaic_masked(mosaic, raw.cfa_pattern, 6, 6)
            if half_size:
                h2, w2 = rgb.shape[1] // 2, rgb.shape[2] // 2
                rgb = rgb[:, : h2 * 2, : w2 * 2]
                rgb = rgb.reshape(3, h2, 2, w2, 2).mean(axis=(2, 4))
        elif half_size:
            rgb = dm.half_size_decode(mosaic, raw.cfa_pattern)
        elif demosaic == "bilinear":
            rgb = dm.demosaic_bilinear(mosaic, raw.cfa_pattern)
        else:
            rgb = dm.demosaic_mhc(mosaic, raw.cfa_pattern)
        rgb = jnp.clip(rgb, 0.0, 1.0)
    else:
        rgb = jnp.moveaxis((data - raw.black_level) * norm, -1, 0)
        rgb = jnp.clip(rgb, 0.0, 1.0)
    if raw.color_matrix is not None:
        cam_to_xyz = np.linalg.inv(np.asarray(raw.color_matrix, np.float64))
        import jax

        rgb = jnp.einsum(
            "ij,jhw->ihw",
            jnp.asarray(cam_to_xyz, jnp.float32),
            rgb,
            precision=jax.lax.Precision.HIGHEST,  # no TF32 input rounding
        )
    orient = int(raw.metadata.get("EXIF:Orientation", 1) or 1)
    if orient != 1:
        rgb = apply_orientation(rgb, orient)
    return rgb


@lru_cache(maxsize=16)
def _load_cached(src: str, half_size: bool):
    raw = read_raw(src)
    xyz = decode_raw(raw, half_size=half_size)
    return xyz, raw.metadata


def raw_to_linear(
    src, half_size: bool = True, cache: bool = True
) -> tuple[jnp.ndarray, dict]:
    """File path (or a pre-parsed RawImage) -> (device (3, H, W) XYZ
    auto-exposed to mid-grey, metadata).

    Reference contract: normalized to [0,1], then scaled by
    2**calc_exposure(...) (src/raw2film/raw_conversion.py:49-52).
    Accepting a RawImage lets callers that already parsed the container
    (e.g. the batch fast-path eligibility check) avoid decoding twice.
    """
    if isinstance(src, RawImage):
        xyz = decode_raw(src, half_size=half_size)
        metadata = src.metadata
    elif cache:
        xyz, metadata = _load_cached(src, half_size)
    else:
        raw = read_raw(src)
        xyz = decode_raw(raw, half_size=half_size)
        metadata = raw.metadata
    # Fetch only the 2x-subsampled green plane the estimator reads (~1/12
    # of the bytes): a full-res 45MP load would otherwise ship ~540 MB to
    # host purely for this scalar.
    lum = np.asarray(xyz[1, ::2, ::2])
    gain = 2.0 ** calc_exposure(lum, metadata=metadata, subsampled=True)
    return xyz * gain, metadata
