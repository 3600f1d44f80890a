"""Lens correction: geometric distortion + vignetting.

The reference delegates to lensfun via lensfunpy (profile DB lookup by EXIF
Make/Model/LensModel, geometry remap + vignetting modification, reference:
src/raw2film/effects.py:22-43, utils.py:24-79, gui.py:556-563). lensfun is
not a dependency here; this module owns:

* a **profile model** with the standard lensfun math: `ptlens`
  (r_d = a*r^4 + b*r^3 + c*r^2 + (1-a-b-c)*r) and `poly3`
  (r_d = k1*r^3 + (1-k1)*r) distortion, and the `pa` vignetting polynomial
  (1 + k1*r^2 + k2*r^4 + k3*r^6),
* a JSON-loadable profile database + loose EXIF matching,
* application: vignetting correction runs on device (pure radial
  elementwise gain); the distortion remap runs on host (bilinear
  map_coordinates) like the reference's CPU pre-stage.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os

import numpy as np
import jax.numpy as jnp


# Profile data provenance, best first. find_profile prefers higher
# confidence among equally-matching models — imported lensfun XML
# ("measured") explicitly outranks the vendored class-derived catalog
# ("heuristic"), not merely by list order.
CONFIDENCE_RANK = {"measured": 0, "curated": 1, "heuristic": 2, "synthetic": 3}


@dataclasses.dataclass(frozen=True)
class LensProfile:
    make: str
    model: str
    crop_factor: float = 1.0
    mount: str = ""
    # distortion: model -> params per focal length (interpolated linearly)
    dist_model: str = "ptlens"  # "ptlens" | "poly3" | "none"
    dist_params: tuple = ()  # ((focal_mm, a, b, c) | (focal_mm, k1), ...)
    # vignetting: ((focal_mm, aperture, k1, k2, k3), ...)
    vig_params: tuple = ()
    # Data provenance: "measured" (lensfun XML import — the default, so
    # user-DB rows without the field keep their measured standing),
    # "curated" (lens_db hand-authored approximations), "heuristic"
    # (lens_catalog class-derived), "synthetic" (test fixture).
    confidence: str = "measured"

    def distortion_at(self, focal: float):
        if self.dist_model == "none" or not self.dist_params:
            return None
        rows = sorted(self.dist_params)
        pts = np.asarray(rows, np.float64)
        out = [
            float(np.interp(focal, pts[:, 0], pts[:, i]))
            for i in range(1, pts.shape[1])
        ]
        return tuple(out)

    def vignetting_at(self, focal: float, aperture: float):
        if not self.vig_params:
            return None
        rows = np.asarray(sorted(self.vig_params), np.float64)
        # nearest focal, then interp over aperture
        focals = np.unique(rows[:, 0])
        f = focals[np.argmin(np.abs(focals - focal))]
        sel = rows[rows[:, 0] == f]
        ks = [float(np.interp(aperture, sel[:, 1], sel[:, 2 + i])) for i in range(3)]
        return tuple(ks)


_BUILTIN_PROFILES: list[LensProfile] = [
    LensProfile(
        make="raw2film-tpu",
        model="synthetic 50mm f/2",
        crop_factor=1.0,
        dist_model="ptlens",
        dist_params=((50.0, 0.0, -0.015, 0.005),),
        vig_params=((50.0, 2.0, -0.9, 0.2, -0.05), (50.0, 8.0, -0.3, 0.05, 0.0)),
        confidence="synthetic",
    ),
]


@functools.lru_cache(maxsize=4)
def _load_user_db(path: str, mtime: float) -> list[LensProfile]:
    with open(path) as f:
        out = []
        for row in json.load(f):
            row["dist_params"] = tuple(tuple(x) for x in row.get("dist_params", []))
            row["vig_params"] = tuple(tuple(x) for x in row.get("vig_params", []))
            out.append(LensProfile(**row))
        return out


def load_profiles(path: str | None = None) -> list[LensProfile]:
    """User JSON database (imported lensfun data takes precedence), then the
    curated built-in set (io/lens_db.py), then the synthetic test profile.

    Called per image from the Processor; the user DB parse is cached keyed
    by (path, mtime) so re-imports are picked up without per-image I/O.
    """
    profiles: list[LensProfile] = []
    candidates = [path] if path else []
    candidates.append(os.path.expanduser("~/.raw2film_tpu/lenses.json"))
    for p in candidates:
        if p and os.path.exists(p):
            profiles.extend(_load_user_db(p, os.path.getmtime(p)))
    from raw2film_tpu.io.lens_catalog import catalog_profiles
    from raw2film_tpu.io.lens_db import PROFILES as _CURATED

    profiles.extend(_CURATED)
    profiles.extend(catalog_profiles())
    profiles.extend(_BUILTIN_PROFILES)
    return profiles


def _loose(a: str, b: str) -> bool:
    a, b = (a or "").lower(), (b or "").lower()
    return bool(a) and bool(b) and (a in b or b in a)


def _compact(s: str) -> str:
    """Normalize a lens-model string for matching: case, spaces and the
    aperture slash vary between a maker's EXIF writer and its catalog name
    ('EF50mm f/1.8 STM' vs 'EF 50mm f/1.8 STM'; Tamron 'F/2.8' vs 'F2.8')."""
    return (s or "").lower().replace(" ", "").replace("/", "")


def _model_match(profile_model: str, exif_model: str) -> bool:
    """One-directional: the profile's canonical model string must appear in
    the EXIF LensModel (both compacted). The reverse direction would let a
    short generic EXIF string ('35mm F1.4' from a manual lens) claim another
    maker's profile — a wrong-model guess silently applies someone else's
    distortion."""
    a, b = _compact(profile_model), _compact(exif_model)
    return bool(a) and bool(b) and a in b


def find_profile(metadata: dict, profiles: list[LensProfile] | None = None):
    """Loose EXIF match, the reference's find_data role
    (src/raw2film/utils.py:24-79). Returns (profile | None).

    Matching is by LENS MODEL substring. A make-level fallback only applies
    when the file carries no LensModel at all, AND the shot's focal length
    falls inside the candidate profile's characterized focal range — a bare
    maker match would hand every LensModel-less Canon file the first Canon
    profile's distortion (a wrong-model guess is worse than no correction).
    """
    profiles = profiles if profiles is not None else load_profiles()
    lens_model = str(metadata.get("EXIF:LensModel", "") or "")
    # Collect ALL model matches and pick the highest-confidence one (ties
    # keep list order): a measured lensfun import beats the vendored
    # heuristic catalog even if it sits later in the profile list.
    matches = [p for p in profiles if _model_match(p.model, lens_model)]
    if matches:
        return min(
            matches, key=lambda p: CONFIDENCE_RANK.get(p.confidence, 9)
        )
    if not lens_model:
        make = str(
            metadata.get("EXIF:LensMake", "") or metadata.get("EXIF:Make", "") or ""
        )
        try:
            focal = float(metadata.get("EXIF:FocalLength"))
        except (TypeError, ValueError):
            focal = None
        if focal is None:
            return None
        for p in profiles:
            if not _loose(p.make, make):
                continue
            focals = [row[0] for row in (p.dist_params or p.vig_params)]
            if focals and min(focals) - 0.5 <= focal <= max(focals) + 0.5:
                return p
    return None


_warned_missing: set = set()


def _warn_missing_profile(metadata: dict) -> None:
    """Once per (make, lens): lens_correction=True with no matching profile
    is a silent no-op otherwise. Import a database with
    ``raw2film-tpu --import-lensfun /usr/share/lensfun``."""
    key = (
        str(metadata.get("EXIF:Make", "")),
        str(metadata.get("EXIF:LensModel", "")),
    )
    if key in _warned_missing or not any(key):
        return
    _warned_missing.add(key)
    import warnings

    warnings.warn(
        f"no lens profile for {key[0]!r} / {key[1]!r}; lens correction "
        "skipped (run raw2film-tpu --import-lensfun <lensfun-db-dir> to "
        "build a profile database)",
        stacklevel=3,
    )


def vignetting_gain(
    shape_hw: tuple[int, int], ks: tuple[float, float, float]
) -> jnp.ndarray:
    """(H, W) multiplicative correction = 1 / (1 + k1 r^2 + k2 r^4 + k3 r^6),
    r normalized to the half-diagonal. Device elementwise."""
    h, w = shape_hw
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    norm = 1.0 / math.hypot(cy, cx)
    yy = (jnp.arange(h, dtype=jnp.float32) - cy)[:, None] * norm
    xx = (jnp.arange(w, dtype=jnp.float32) - cx)[None, :] * norm
    r2 = yy * yy + xx * xx
    k1, k2, k3 = ks
    falloff = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    return 1.0 / jnp.clip(falloff, 0.05, None)


def undistort_coords(
    shape_hw: tuple[int, int], model: str, params: tuple
) -> np.ndarray:
    """(2, H, W) source coordinates implementing the inverse radial map:
    sample the distorted capture at r_d(r_u) for each undistorted pixel."""
    h, w = shape_hw
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    norm = 1.0 / math.hypot(cy, cx)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    dy = (yy - cy) * norm
    dx = (xx - cx) * norm
    r = np.sqrt(dy * dy + dx * dx)
    r_safe = np.maximum(r, 1e-9)
    if model == "ptlens":
        a, b, c = params
        scale = a * r**3 + b * r**2 + c * r + (1 - a - b - c)
    elif model == "poly3":
        (k1,) = params
        scale = k1 * r**2 + (1 - k1)
    else:
        scale = np.ones_like(r)
    src_y = cy + dy * scale / norm
    src_x = cx + dx * scale / norm
    return np.stack([src_y, src_x])


def lens_correction(
    img: np.ndarray,
    metadata: dict,
    profile: LensProfile | None = None,
) -> np.ndarray:
    """Apply distortion + vignetting correction to planar (3, H, W) float.

    Host remap (scipy bilinear) + device-friendly vignetting gain; mirrors
    the reference's float64 lens_correction contract
    (src/raw2film/effects.py:22-43): silently returns the input when EXIF
    or a profile is missing.
    """
    if profile is None:
        profile = find_profile(metadata)
    if profile is None:
        _warn_missing_profile(metadata)
        return img
    try:
        focal = float(metadata["EXIF:FocalLength"])
        aperture = float(metadata["EXIF:FNumber"])
    except (KeyError, TypeError, ValueError):
        return img

    h, w = img.shape[-2:]
    out = np.asarray(img, np.float64)

    dist = profile.distortion_at(focal)
    if dist is not None:
        coords = undistort_coords((h, w), profile.dist_model, dist)
        from raw2film_tpu.native import remap_bilinear

        native = remap_bilinear(np.asarray(out, np.float32), coords)
        if native is not None:
            # Threaded C++ bilinear (~50x scipy at 24MP on the host — see
            # native/__init__.py).
            out = native.astype(np.float64)
        else:
            from scipy import ndimage

            out = np.stack(
                [
                    ndimage.map_coordinates(
                        out[c], coords, order=1, mode="nearest"
                    )
                    for c in range(out.shape[0])
                ]
            )
        out = np.clip(out, 0.0, None)

    ks = profile.vignetting_at(focal, aperture)
    if ks is not None:
        gain = np.asarray(vignetting_gain((h, w), ks))
        out = out * gain[None]
    return out.astype(np.float32)
