"""Image export: JPEG/TIFF save with EXIF carry-over.

Reference behavior: PIL JPEG save at chosen quality, then exiftool re-attaches
the METADATA_KEYS whitelist + ExposureCompensation (reference:
src/raw2film/gui.py:2285-2355, utils.py:82-90, whitelist data.py:8-85).
Here the whitelist is written directly through PIL's Exif container with
proper EXIF/GPS sub-IFD routing; when an ``exiftool`` binary exists on PATH
it is used afterwards for any keys PIL cannot express (vendor/composite
tags), matching the reference's behavior without requiring it.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np

from raw2film_tpu.data import METADATA_KEYS

IFD0 = 0
IFD_EXIF = 0x8769
IFD_GPS = 0x8825

# Whitelist key -> (ifd, tag id). Standard EXIF 2.32 ids.
_EXIF_TAG_IDS: dict[str, tuple[int, int]] = {
    # IFD0
    "ProcessingSoftware": (IFD0, 11),
    "Make": (IFD0, 271),
    "Model": (IFD0, 272),
    "XResolution": (IFD0, 282),
    "YResolution": (IFD0, 283),
    "ResolutionUnit": (IFD0, 296),
    "Software": (IFD0, 305),
    "ModifyDate": (IFD0, 306),
    "YCbCrPositioning": (IFD0, 531),
    "Copyright": (IFD0, 33432),
    # EXIF sub-IFD
    "ExposureTime": (IFD_EXIF, 33434),
    "FNumber": (IFD_EXIF, 33437),
    "ExposureProgram": (IFD_EXIF, 34850),
    "ISO": (IFD_EXIF, 34855),
    "SensitivityType": (IFD_EXIF, 34864),
    "DateTimeOriginal": (IFD_EXIF, 36867),
    "CreateDate": (IFD_EXIF, 36868),
    "OffsetTime": (IFD_EXIF, 36880),
    "OffsetTimeOriginal": (IFD_EXIF, 36881),
    "OffsetTimeDigitized": (IFD_EXIF, 36882),
    "ShutterSpeedValue": (IFD_EXIF, 37377),
    "ApertureValue": (IFD_EXIF, 37378),
    "BrightnessValue": (IFD_EXIF, 37379),
    "ExposureCompensation": (IFD_EXIF, 37380),
    "MaxApertureValue": (IFD_EXIF, 37381),
    "SubjectDistance": (IFD_EXIF, 37382),
    "MeteringMode": (IFD_EXIF, 37383),
    "LightSource": (IFD_EXIF, 37384),
    "Flash": (IFD_EXIF, 37385),
    "FocalLength": (IFD_EXIF, 37386),
    "SubSecTime": (IFD_EXIF, 37520),
    "SubSecTimeOriginal": (IFD_EXIF, 37521),
    "SubSecTimeDigitized": (IFD_EXIF, 37522),
    "ColorSpace": (IFD_EXIF, 40961),
    "ExifImageWidth": (IFD_EXIF, 40962),
    "FocalPlaneXResolution": (IFD_EXIF, 41486),
    "FocalPlaneYResolution": (IFD_EXIF, 41487),
    "FocalPlaneResolutionUnit": (IFD_EXIF, 41488),
    "SensingMethod": (IFD_EXIF, 41495),
    "ExposureMode": (IFD_EXIF, 41986),
    "WhiteBalance": (IFD_EXIF, 41987),
    "DigitalZoomRatio": (IFD_EXIF, 41988),
    "FocalLengthIn35mmFormat": (IFD_EXIF, 41989),
    "SceneCaptureType": (IFD_EXIF, 41990),
    "Contrast": (IFD_EXIF, 41992),
    "Saturation": (IFD_EXIF, 41993),
    "SubjectDistanceRange": (IFD_EXIF, 41996),
    "LensMake": (IFD_EXIF, 42035),
    "LensModel": (IFD_EXIF, 42036),
    "CompositeImage": (IFD_EXIF, 42080),
    "ComponentsConfiguration": (IFD_EXIF, 37121),
    "FileSource": (IFD_EXIF, 41728),
    "SceneType": (IFD_EXIF, 41729),
    # GPS sub-IFD
    "GPSVersionID": (IFD_GPS, 0),
    "GPSLatitudeRef": (IFD_GPS, 1),
    "GPSLatitude": (IFD_GPS, 2),
    "GPSLongitudeRef": (IFD_GPS, 3),
    "GPSLongitude": (IFD_GPS, 4),
    "GPSAltitudeRef": (IFD_GPS, 5),
    "GPSAltitude": (IFD_GPS, 6),
    "GPSTimeStamp": (IFD_GPS, 7),
    "GPSImgDirectionRef": (IFD_GPS, 16),
    "GPSImgDirection": (IFD_GPS, 17),
    "GPSDateStamp": (IFD_GPS, 29),
}
# Whitelist keys with no PIL-writable EXIF tag — covered by the exiftool
# fallback only: LightValue is an exiftool composite;
# Sensor{Width,Height,Top/Bottom/Left/RightBorder} are RAW vendor tags;
# Compression/ThumbnailLength belong to the writer-managed thumbnail IFD1;
# InteropIndex lives in the Interop sub-IFD which PIL does not serialize.


def build_exif(metadata: dict, exp_comp: float | None = None):
    """Whitelisted EXIF dict -> PIL Exif object (EXIF/GPS sub-IFD routed).
    Pillow is imported here, not at module load, so the rest of the package
    (and every device path) imports on hosts without it."""
    from PIL import Image

    exif = Image.Exif()
    ifds = {
        IFD_EXIF: exif.get_ifd(IFD_EXIF),
        IFD_GPS: exif.get_ifd(IFD_GPS),
    }
    for key, value in (metadata or {}).items():
        name = key.split(":")[-1]
        if name not in METADATA_KEYS:
            continue
        dest = _EXIF_TAG_IDS.get(name)
        if dest is None:
            continue
        ifd, tag = dest
        if isinstance(value, list):
            value = tuple(value)
        if ifd == IFD0:
            exif[tag] = value
        else:
            ifds[ifd][tag] = value
    if exp_comp is not None:
        ifds[IFD_EXIF][_EXIF_TAG_IDS["ExposureCompensation"][1]] = float(exp_comp)
    exif[_EXIF_TAG_IDS["Software"][1]] = "raw2film-tpu"
    return exif


def _exiftool_path() -> str | None:
    return shutil.which("exiftool")


def add_metadata_exiftool(dst: str, metadata: dict) -> bool:
    """Re-attach every whitelisted key via exiftool when available
    (reference: src/raw2film/utils.py:82-90). Returns False if exiftool is
    missing or fails; the PIL-written EXIF already covers the standard tags.
    """
    tool = _exiftool_path()
    if not tool:
        return False
    args = [tool, "-overwrite_original", "-q"]
    for key, value in (metadata or {}).items():
        name = key.split(":")[-1]
        if name not in METADATA_KEYS:
            continue
        if isinstance(value, (list, tuple)):
            value = " ".join(str(v) for v in value)
        args.append(f"-{name}={value}")
    args.append(dst)
    try:
        return subprocess.run(args, capture_output=True, timeout=30).returncode == 0
    except Exception:
        return False


def save_image(
    image_hwc: np.ndarray,
    dst: str,
    quality: int = 95,
    metadata: dict | None = None,
    exp_comp: float | None = None,
    use_exiftool: bool = True,
) -> None:
    """uint8 (H, W, 3) -> JPEG/TIFF/PNG by extension, EXIF attached."""
    from PIL import Image

    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    img = Image.fromarray(np.ascontiguousarray(image_hwc))
    ext = os.path.splitext(dst)[1].lower()
    kwargs = {"exif": build_exif(metadata, exp_comp)}
    if ext in (".jpg", ".jpeg"):
        kwargs.update(quality=quality, subsampling=0)
    img.save(dst, **kwargs)
    if use_exiftool and metadata and _exiftool_path():
        add_metadata_exiftool(dst, metadata)
