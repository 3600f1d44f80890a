"""Processor: the public ``process()`` API — one engine for preview + export.

Replaces both reference engines (CpuProcessor, src/raw2film/cpu_processor.py
:24-414, and GpuProcessor, gpu_processor.py) with a single class around the
jitted device chain. The ``process()`` signature carries the same parameter
names and defaults as the reference's so existing settings/profile JSONs map
over directly.

Caching mirrors the reference's param-dict memoization (cpu_processor.py:
41-45): geometry/decode results and calibrated film bundles are reused when
their parameter dicts are unchanged; jit handles kernel caching by static
config.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from raw2film_tpu.film import chain as fchain
from raw2film_tpu.film.loader import load_film_stocks
from raw2film_tpu.film.stock import FilmStock
from raw2film_tpu.ops.resize import resolution_scaling
from raw2film_tpu.pipeline import geometry
from raw2film_tpu.pipeline.canvas import add_canvas
from raw2film_tpu.pipeline.render import (
    RenderConfig,
    build_render_config,
    make_film_bundle,
    render_jit,
)

MAX_SCALE_DEFAULT = 400.0  # px/mm preview cap (reference: cpu_processor.py:320)


def _resolve_stock(stock) -> FilmStock | None:
    if stock is None or isinstance(stock, FilmStock):
        return stock
    return load_film_stocks()[str(stock)]


def _aspect_crop_window(h: int, w: int, aspect: float) -> tuple[slice, slice]:
    """The (rows, cols) window geometry.crop_to_aspect would keep on the
    demosaiced (C, h, w) image — a literal transcription of its branch
    structure (x = rows, y = cols), verified branch-for-branch by
    tests/test_pipeline.py::test_aspect_window_matches_crop_to_aspect."""
    import math

    x, y = h, w
    if x > y:
        if x > aspect * y:
            lo = math.ceil(x / 2 - y * aspect / 2)
            hi = math.ceil(x / 2 + y * aspect / 2)
            return slice(lo, hi), slice(0, y)
        lo = math.ceil(y / 2 - x / aspect / 2)
        hi = math.ceil(y / 2 + x / aspect / 2)
        return slice(0, x), slice(lo, hi)
    if y > aspect * x:
        lo = math.ceil(y / 2 - x * aspect / 2)
        hi = math.ceil(y / 2 + x * aspect / 2)
        return slice(0, x), slice(lo, hi)
    lo = math.ceil(x / 2 - y / aspect / 2)
    hi = math.ceil(x / 2 + y / aspect / 2)
    return slice(lo, hi), slice(0, y)


def _staged_crop_window(h: int, w: int, aspect: float) -> tuple[slice, slice]:
    """The COMPOSED window of geometry.crop_rotate_zoom's two
    crop_to_aspect applications (rotation=0 path: crop, no-op rotate, crop
    again — the ceil-center crop is not idempotent, e.g. a square input
    loses one extra row on the second pass)."""
    r1, c1 = _aspect_crop_window(h, w, aspect)
    r2, c2 = _aspect_crop_window(r1.stop - r1.start, c1.stop - c1.start, aspect)
    return (
        slice(r1.start + r2.start, r1.start + r2.stop),
        slice(c1.start + c2.start, c1.start + c2.stop),
    )


def _mosaic_aspect_crop(
    mosaic: np.ndarray, aspect: float
) -> tuple[np.ndarray, tuple[int, int, int, int] | None]:
    """Pre-crop an (H, W) mosaic for the fused path so the post-demosaic
    window matches geometry.crop_rotate_zoom EXACTLY: crop an even-aligned
    superset (Bayer phase preserved, +4 px context so the demosaic kernels
    see the same neighbors as a full-frame demosaic) and return the inner
    (y0, x0, h, w) to slice after demosaic (None = no slice needed)."""
    h, w = mosaic.shape
    rows, cols = _staged_crop_window(h, w, aspect)
    ext = 4
    y_lo = max(rows.start - ext, 0)
    y_lo -= y_lo % 2
    x_lo = max(cols.start - ext, 0)
    x_lo -= x_lo % 2
    y_hi = min(rows.stop + ext, h)
    x_hi = min(cols.stop + ext, w)
    sup = mosaic[y_lo:y_hi, x_lo:x_hi]
    dy, dx = rows.start - y_lo, cols.start - x_lo
    ch, cw = rows.stop - rows.start, cols.stop - cols.start
    if (dy, dx) == (0, 0) and sup.shape == (ch, cw):
        return np.ascontiguousarray(sup), None
    return np.ascontiguousarray(sup), (dy, dx, ch, cw)


def _half_size_xyz(
    mosaic: np.ndarray,
    pattern: str,
    cam_to_xyz: np.ndarray,
    black: float = 0.0,
    inv_range: float = 1.0,
):
    """Cheap host half-size decode -> (3, H/2, W/2) XYZ for the exposure
    estimator (same statistic the staged path computes on the full-res
    demosaic; the power-mean is a global scalar, so the half-size sample
    agrees to ~0.01 stop). Takes raw integer codes + normalization params
    so callers never materialize a full-resolution normalized f32 frame
    just to feed the quarter-size subsample here."""
    h2, w2 = mosaic.shape[0] // 2, mosaic.shape[1] // 2
    m = mosaic[: h2 * 2, : w2 * 2]

    def cell(y, x):  # quarter-size plane, normalized+clipped per pixel
        p = m[y::2, x::2].astype(np.float32)
        return np.clip((p - black) * inv_range, 0.0, 1.0)

    c00, c01, c10, c11 = cell(0, 0), cell(0, 1), cell(1, 0), cell(1, 1)
    cells = {pattern[0]: c00, pattern[1]: c01, pattern[2]: c10, pattern[3]: c11}
    greens = [
        c01 if pattern[1] == "G" else None,
        c10 if pattern[2] == "G" else None,
    ]
    g = np.mean([x for x in greens if x is not None], axis=0) if any(
        x is not None for x in greens
    ) else cells.get("G", c00)
    rgb = np.stack([cells.get("R", g), g, cells.get("B", g)])
    return np.einsum("ij,jhw->ihw", cam_to_xyz, rgb).astype(np.float32)


class Processor:
    """Stateful wrapper: image/LUT caches + ``process()``."""

    def __init__(self, cameras=None, lenses=None):
        # cameras/lenses kept for API compatibility with the reference's
        # lensfun-backed constructor (cpu_processor.py:27); lens correction is
        # handled by io.lens when profiles are available.
        from raw2film_tpu.config import enable_persistent_jit_cache

        enable_persistent_jit_cache()
        self.cameras = cameras or {}
        self.lenses = lenses or {}
        self._image_cache_key = None
        self._image_cache = None
        self._mosaic_cache_key = None
        self._mosaic_cache = None
        self._bundle_key = None
        self._bundle = None
        self._d_ref_green = 1.0
        self._icc_cache: dict = {}
        self.last_metadata: dict = {}

    def register_lens(self, name: str) -> bool:
        """Resolve a lens model name from the profile DB into ``lenses`` so
        ``process(lens=name)`` honors a manual override (the reference's
        lens-model selector, src/raw2film/gui.py:603-612). Returns whether
        the name now resolves."""
        if not name or name in self.lenses:
            return bool(name) and name in self.lenses
        from raw2film_tpu.io import lens as lens_mod

        for p in lens_mod.load_profiles():
            if p.model == name:
                self.lenses[name] = p
                return True
        return False

    # ------------------------------------------------------------ image

    def load_image(
        self,
        src,
        frame_width=36.0,
        frame_height=24.0,
        rotation=0.0,
        zoom=1.0,
        rotate_times=0,
        flip=False,
        resolution=None,
        half_size=True,
        cache=True,
        chroma_nr=0,
        max_scale=None,
        lens_correction=False,
        cam=None,
        lens=None,
    ):
        """Decode + geometry; returns (device planar XYZ, orig_resolution).

        ``chroma_nr`` is accepted for kwarg-surface symmetry with
        ``process()`` but unused here: NR runs inside the jitted chain
        (cfg.chroma_nr), never at decode time."""
        del chroma_nr
        from raw2film_tpu.io.dng import RawImage as _RawImage

        if isinstance(src, _RawImage):
            # Never cache by a RawImage: a freed instance's id can be
            # reused by the next allocation, which would serve the previous
            # file's pixels.
            cache = False
        key = (
            str(src) if not isinstance(src, _RawImage) else None,
            frame_width,
            frame_height,
            rotation,
            zoom,
            rotate_times,
            flip,
            tuple(resolution) if resolution is not None else None,
            half_size,
            max_scale,
            lens_correction,
            str(lens),
        )
        if cache and key == self._image_cache_key:
            return self._image_cache

        if isinstance(src, np.ndarray):
            xyz = np.asarray(src, np.float32)
            if xyz.ndim == 3 and xyz.shape[-1] == 3 and xyz.shape[0] != 3:
                xyz = xyz.transpose(2, 0, 1)  # accept HWC input
            metadata = {}
        else:
            from raw2film_tpu.io.dng import RawImage
            from raw2film_tpu.io.raw import raw_to_linear

            arg = src if isinstance(src, RawImage) else str(src)
            dev_xyz, metadata = raw_to_linear(arg, half_size=half_size, cache=cache)
            xyz = np.asarray(dev_xyz)

        if lens_correction and metadata:
            from raw2film_tpu.io import lens as lens_mod

            profile = self.lenses.get(lens) if lens else None
            xyz = lens_mod.lens_correction(xyz, metadata, profile)

        xyz = geometry.crop_rotate_zoom(
            xyz, frame_width, frame_height, rotation, zoom, rotate_times, flip
        )

        if resolution is None and max_scale is not None:
            resolution = xyz.shape[-2:]
        orig_resolution = tuple(resolution) if resolution is not None else None

        if resolution is not None:
            scale = max(resolution) / max(frame_width, frame_height)
            if max_scale is not None and scale > max_scale:
                f = max_scale / scale
                resolution = [round(v * f) for v in resolution]
            xyz = np.asarray(
                resolution_scaling(jnp.asarray(xyz), tuple(resolution))
            )

        result = (jnp.asarray(xyz), orig_resolution, metadata)
        if cache:
            self._image_cache_key = key
            self._image_cache = result
        return result

    # ------------------------------------------------------------ bundles

    def load_film_bundle(self, negative_film, print_film, merged: dict):
        key = {
            "negative_film": negative_film.name,
            "print_film": print_film.name if print_film is not None else None,
            **{
                k: merged[k]
                for k in (
                    "exp_kelvin",
                    "tint",
                    "exp_comp",
                    "push_pull",
                    "color_masking",
                    "red_light",
                    "green_light",
                    "blue_light",
                    "projector_kelvin",
                    "shadow_comp",
                    "sat_adjust",
                    "inversion_gamma",
                    "idealized_curve",
                    "white_balance",
                    "white_clip",
                    "gamma_func",
                    "halation_intensity",
                    "halation_green_factor",
                    "highlight_burn",
                )
            },
            "inversion": merged.get("inversion", False),
        }
        if key == self._bundle_key:
            return self._bundle

        neg_p = fchain.build_negative_params(
            negative_film,
            exp_kelvin=merged["exp_kelvin"],
            tint=merged["tint"],
            exp_comp=merged["exp_comp"],
            push_pull=merged["push_pull"],
            color_masking=merged["color_masking"],
        )
        inversion = bool(merged.get("inversion", False)) or (
            print_film is None and negative_film.film_type == "negative"
        )
        prt_p = fchain.build_print_params(
            negative_film,
            print_film,
            red_light=merged["red_light"],
            green_light=merged["green_light"],
            blue_light=merged["blue_light"],
            projector_kelvin=merged["projector_kelvin"],
            shadow_comp=merged["shadow_comp"],
            inversion_gamma=merged["inversion_gamma"],
            idealized_curve=merged["idealized_curve"],
            inversion=inversion,
            white_balance=merged["white_balance"],
            neg_params=neg_p,
        )
        out_p = fchain.build_output_params(
            negative_film,
            print_film,
            prt_p,
            neg_p,
            projector_kelvin=merged["projector_kelvin"],
            sat_adjust=merged["sat_adjust"],
            gamma_func=merged["gamma_func"],
            white_clip=merged["white_clip"],
        )
        d_ref = negative_film.d_ref
        d_ref_green = float(d_ref[1] if len(d_ref) > 1 else d_ref[0])
        gm = negative_film.grain
        d_min, *_ = negative_film.curve.params()
        lo = float(np.min(d_min))
        hi = float(np.max(negative_film.curve.d_max))
        if hi < lo:
            lo, hi = hi, lo
        bundle = make_film_bundle(
            neg_p,
            prt_p,
            out_p,
            halation_intensity=merged["halation_intensity"],
            halation_green_factor=merged["halation_green_factor"],
            highlight_burn=merged["highlight_burn"],
            d_ref_green=d_ref_green,
            grain_rms=(gm.rms if gm else 0.0),
            grain_shape=(
                (gm.peak_density, gm.width, gm.floor, lo, hi)
                if gm
                else (1.0, 1.2, 0.15, 0.0, 4.0)
            ),
            sat=merged["sat_adjust"],
        )
        self._bundle_key = key
        self._bundle = (bundle, prt_p.mode)
        self._d_ref_green = d_ref_green
        return self._bundle

    # ------------------------------------------------------------ process

    def process(
        self,
        src,
        negative_film,
        grain_size: float = 6.0,
        grain_sigma: float = 0.4,
        lens_correction: bool = True,
        print_film=None,
        exp_comp: float = 0.0,
        red_light: float = 0.0,
        green_light: float = 0.0,
        blue_light: float = 0.0,
        projector_kelvin: float = 6500.0,
        shadow_comp: float = 0.0,
        sat_adjust: float = 1.0,
        gamma_func: str = "sRGB",
        exp_kelvin: float = 6500.0,
        tint: float = 0.0,
        inversion_gamma: float = 4.0,
        idealized_curve: bool = False,
        inversion: bool = False,
        push_pull: float = 0.0,
        white_balance: bool = False,
        white_clip: bool = False,
        icc_transform=None,
        resolution=None,
        frame_width: float = 36.0,
        frame_height: float = 24.0,
        rotation: float = 0.0,
        zoom: float = 1.0,
        rotate_times: int = 0,
        flip: bool = False,
        cam=None,
        lens=None,
        canvas_mode: str = "No",
        canvas_scale: float = 1.0,
        canvas_ratio: float = 1.0,
        halation_intensity: float = 1.0,
        halation: bool = True,
        halation_size: float = 1.0,
        halation_green_factor: float = 0.4,
        sharpness: bool = True,
        sharpening_strength: float = 0.0,
        sharpening_sigma: float = 1.0,
        chroma_nr: int = 0,
        grain: int = 2,
        highlight_burn: float = 0.0,
        burn_scale: float = 50.0,
        half_size: bool = True,
        cache: bool = True,
        color_masking: float | None = None,
        mtf_fidelity: bool = False,
        max_scale: float | None = MAX_SCALE_DEFAULT,
        seed: int = 0,
        fused_decode: bool = True,
        **_,
    ) -> np.ndarray:
        """Load and process an image; returns uint8 (H, W, 3).

        Parameter surface mirrors the reference
        (src/raw2film/cpu_processor.py:269-414). ``fused_decode`` matches
        process_batch: eligible full-res sources render through the fused
        mosaic-in program (1/3 the host->device bytes; ≤2 u8 codes vs the
        staged path, from the exposure-estimator sample — pinned in
        tests/test_pipeline.py); pass False to force the staged path.
        """
        negative_film = _resolve_stock(negative_film)
        print_film = _resolve_stock(print_film)

        # Fused-decode fast path (same eligibility as process_batch): the
        # u16-derived mosaic uploads at 1/3 the bytes of decoded f32 XYZ
        # (45MP: 180 MB vs 540 MB host->device) and demosaic + camera
        # matrix + exposure fold into the render program. This is the
        # batch-export configuration (the CLI hands decoded RawImages
        # here); interactive paths (half_size / geometry / lens work)
        # fall through to the staged decode below.
        fast = parsed = None
        if fused_decode:
            fast, parsed = self._try_load_mosaic(
                src,
                dict(
                    half_size=half_size, rotation=rotation, zoom=zoom,
                    rotate_times=rotate_times, flip=flip,
                    resolution=resolution, chroma_nr=chroma_nr,
                    max_scale=max_scale, lens_correction=lens_correction,
                    cam=cam, lens=lens, frame_width=frame_width,
                    frame_height=frame_height,
                ),
                cache=cache,
            )
        if fast is not None:
            xyz, orig_resolution = None, None
            self.last_metadata = dict(parsed.metadata or {})
        else:
            xyz, orig_resolution, _meta = self.load_image(
                parsed if parsed is not None else src,
                frame_width,
                frame_height,
                rotation,
                zoom,
                rotate_times,
                flip,
                resolution,
                half_size,
                cache,
                chroma_nr,
                max_scale,
                lens_correction=lens_correction,
                cam=cam,
                lens=lens,
            )
            # Exporters read EXIF from here instead of re-decoding the RAW.
            self.last_metadata = dict(_meta or {})

        merged = dict(
            exp_kelvin=exp_kelvin,
            tint=tint,
            exp_comp=exp_comp,
            push_pull=push_pull,
            color_masking=color_masking if color_masking is not None else 1.0,
            red_light=red_light,
            green_light=green_light,
            blue_light=blue_light,
            projector_kelvin=projector_kelvin,
            shadow_comp=shadow_comp,
            sat_adjust=sat_adjust,
            inversion_gamma=inversion_gamma,
            idealized_curve=idealized_curve,
            inversion=inversion,
            white_balance=white_balance,
            white_clip=white_clip,
            gamma_func=gamma_func,
            halation_intensity=halation_intensity,
            halation_green_factor=halation_green_factor,
            highlight_burn=highlight_burn,
            halation=halation,
            halation_size=halation_size,
            sharpness=sharpness,
            sharpening_strength=sharpening_strength,
            sharpening_sigma=sharpening_sigma,
            grain=grain,
            grain_size=grain_size,
            grain_sigma=grain_sigma,
            burn_scale=burn_scale,
            chroma_nr=chroma_nr,
            mtf_fidelity=mtf_fidelity,
        )
        bundle, prt_mode = self.load_film_bundle(negative_film, print_film, merged)

        if fast is not None:
            mosaic, norm, pattern, cam_m, gain, crop = fast
            out_shape = (crop[2], crop[3]) if crop is not None else mosaic.shape
            scale = max(out_shape) / max(frame_width, frame_height)
        else:
            scale = max(xyz.shape[-2:]) / max(frame_width, frame_height)
        cfg = build_render_config(negative_film, print_film, prt_mode, scale, merged)
        bundle, cfg = self._attach_icc(bundle, cfg, icc_transform)

        # fold_in(base, position): the same derivation process_batch uses, so
        # a single render equals the batch render of the same image at
        # position 0 bit-for-bit, grain included.
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 0)
        if fast is not None:
            from raw2film_tpu.pipeline.render import render_mosaic_jit

            out = render_mosaic_jit(
                jnp.asarray(mosaic), jnp.asarray(cam_m), jnp.float32(gain),
                bundle, cfg, key, pattern, crop, jnp.asarray(norm),
            )  # (3, H, W) uint8
        else:
            out = render_jit(xyz, bundle, cfg, key)  # (3, H, W) uint8

        image = self._finish(np.asarray(out), None, canvas_mode,
                             canvas_scale, canvas_ratio, orig_resolution)
        return image

    def _icc_arrays(self, icc_transform):
        """CP-factored (u, v, w) device arrays for an ICC transform, cached
        per transform object."""
        from raw2film_tpu.io.icc import bake_output_cp

        key = id(icc_transform)
        cached = self._icc_cache.get(key)
        if cached is None or cached[0] is not icc_transform:
            u, v, w_bc, err = bake_output_cp(icc_transform)
            cached = (icc_transform, (jnp.asarray(u), jnp.asarray(v), jnp.asarray(w_bc)), err)
            self._icc_cache[key] = cached
        return cached[1]

    def _attach_icc(self, bundle: dict, cfg, icc_transform):
        """Bake an ICC transform into a CP-factored output LUT carried in
        the bundle (cached per transform object); cfg.icc flags the jitted
        chain to apply it pre-quantization."""
        if icc_transform is None:
            return bundle, cfg
        import dataclasses

        bundle = dict(bundle)
        bundle["icc_u"], bundle["icc_v"], bundle["icc_w"] = self._icc_arrays(
            icc_transform
        )
        return bundle, dataclasses.replace(cfg, icc=True)

    def _finish(
        self,
        out_chw: np.ndarray,
        icc_transform,
        canvas_mode,
        canvas_scale,
        canvas_ratio,
        orig_resolution,
    ) -> np.ndarray:
        image = out_chw.transpose(1, 2, 0)  # HWC for the host side
        if icc_transform is not None:
            # The reference bakes ICC into its 33^3 output LUT
            # (cpu_processor.py:255-263); the closed-form chain has no output
            # LUT, so the transform applies to the rendered uint8 directly.
            from raw2film_tpu.io.icc import apply_transform_to_image

            image = apply_transform_to_image(image, icc_transform)
        image = add_canvas(image, canvas_mode, canvas_scale, canvas_ratio)
        if orig_resolution is not None and tuple(image.shape[:2]) != tuple(
            orig_resolution
        ):
            scaled = resolution_scaling(
                jnp.asarray(image.transpose(2, 0, 1), jnp.float32),
                tuple(orig_resolution),
            )
            image = np.clip(np.asarray(scaled), 0, 255).astype(np.uint8).transpose(1, 2, 0)
        return image

    # ---------------------------------------------------------- batch

    def _try_load_mosaic(self, src, load_kw: dict, cache: bool = False):
        """Single-slot caching wrapper over the eligibility/prep work: with
        ``cache=True`` (process()'s default contract) a repeat call on the
        same path + knobs skips the host decode — the multi-second wall for
        a 45MP compressed source (e.g. one photo rendered through several
        film stocks in a loop). Keyed by path only, never by a RawImage
        instance (freed ids can be reused, same rule as load_image)."""
        from raw2film_tpu.io.dng import RawImage

        if not cache or isinstance(src, (np.ndarray, RawImage)):
            return self._try_load_mosaic_impl(src, load_kw)
        key = (str(src), repr(sorted(load_kw.items(), key=lambda kv: kv[0])))
        if key == self._mosaic_cache_key:
            return self._mosaic_cache
        result = self._try_load_mosaic_impl(src, load_kw)
        self._mosaic_cache_key = key
        self._mosaic_cache = result
        return result

    def _try_load_mosaic_impl(self, src, load_kw: dict):
        """Fused-decode eligibility + host prep for one source. Returns
        (fast_tuple | None, parsed RawImage | None): the fast tuple =
        (normalized mosaic, pattern, cam_to_xyz, exposure_gain, crop) when
        eligible; otherwise the already-parsed RawImage is handed back so
        the standard path never decodes the file twice (host decode is the
        batch wall-clock bottleneck)."""
        from raw2film_tpu.io.dng import RawImage, read_raw

        if isinstance(src, np.ndarray):
            return None, None
        if load_kw.get("half_size", True):
            return None, None
        for k in ("rotation", "rotate_times", "flip", "chroma_nr"):
            if load_kw.get(k):
                return None, None
        if float(load_kw.get("zoom", 1.0)) != 1.0:
            return None, None
        if load_kw.get("resolution") is not None or load_kw.get("max_scale") is not None:
            return None, None
        if load_kw.get("cam") is not None:
            return None, None  # explicit camera-matrix override: staged only
        # An already-decoded RawImage (the CLI's decode pool hands these to
        # process()) skips the re-decode.
        raw = src if isinstance(src, RawImage) else read_raw(str(src))
        if raw.cfa_pattern is None or len(raw.cfa_pattern) != 4:
            return None, raw
        if int(raw.metadata.get("EXIF:Orientation", 1) or 1) != 1:
            return None, raw
        if load_kw.get("lens_correction"):
            # Eligible only when lens correction is a provable no-op (no
            # matching profile — the staged path would warn and pass the
            # image through unchanged).
            from raw2film_tpu.io import lens as lens_mod

            lens_name = load_kw.get("lens")
            prof = (
                self.lenses.get(lens_name)
                if lens_name
                else lens_mod.find_profile(raw.metadata)
            )
            if prof is not None:
                return None, raw
        inv_range = 1.0 / max(raw.white_level - raw.black_level, 1.0)
        norm = np.asarray([raw.black_level, inv_range], np.float32)
        # Normalization happens ON DEVICE (render_chain_from_mosaic norm
        # arg): the upload is the raw u16 codes — 2 bytes/pixel instead of
        # the 4-byte normalized f32 plane. The exposure estimate below
        # normalizes only its quarter-size subsampled planes, so no
        # full-resolution f32 transient is ever materialized on host.
        mosaic_u16 = np.ascontiguousarray(raw.data)
        if mosaic_u16.dtype != np.uint16:
            # Several readers (RAF/RW2) hand back integral sensor codes as
            # f32; casting them to u16 halves the upload AND keeps every
            # container on the ONE compiled u16 program (a separate f32
            # variant would cold-compile per dtype).
            as_u16 = mosaic_u16.astype(np.uint16)
            if (
                mosaic_u16.min() >= 0.0
                and mosaic_u16.max() <= 65535.0
                and np.array_equal(
                    as_u16.astype(mosaic_u16.dtype), mosaic_u16
                )
            ):
                mosaic_u16 = as_u16
        cam = (
            np.linalg.inv(np.asarray(raw.color_matrix, np.float64))
            if raw.color_matrix is not None
            else np.eye(3)
        ).astype(np.float32)
        from raw2film_tpu.io.raw import calc_exposure

        # The staged path estimates exposure on the FULL decoded frame
        # (raw_to_linear runs before the aspect crop) — match that.
        gain = np.float32(
            2.0
            ** calc_exposure(
                _half_size_xyz(
                    raw.data,
                    raw.cfa_pattern,
                    cam,
                    black=float(raw.black_level),
                    inv_range=float(inv_range),
                ),
                metadata=raw.metadata,
            )
        )
        fw = float(load_kw.get("frame_width", 36.0))
        fh = float(load_kw.get("frame_height", 24.0))
        mosaic, crop = _mosaic_aspect_crop(mosaic_u16, fw / fh)
        # The parsed RawImage rides along so fast-path callers can surface
        # its EXIF (process() exporters read last_metadata).
        return (mosaic, norm, raw.cfa_pattern, cam, gain, crop), raw

    def process_batch(
        self,
        srcs: list,
        negative_film,
        mesh=None,
        seed: int = 0,
        **params,
    ) -> list[np.ndarray]:
        """Render many images through ONE vmapped (optionally mesh-sharded)
        device call per same-shape bucket.

        The replacement for the reference's per-image GPU loop
        (gui_objects.py:65-115): images are decoded on host, grouped by
        pipeline shape, stacked to (B, 3, H, W), and the whole batch renders
        in a single dispatch — sharded over the mesh's 'batch' axis when a
        mesh is given. Canvas/resize/ICC finishing stays per-image on host.
        """
        import jax as _jax

        from raw2film_tpu.parallel.mesh import batch_render_fn, sharded_batch_render

        negative_film = _resolve_stock(negative_film)
        print_film = _resolve_stock(params.pop("print_film", None))

        load_keys = (
            "frame_width", "frame_height", "rotation", "zoom", "rotate_times",
            "flip", "resolution", "half_size", "chroma_nr",
            "max_scale", "lens_correction", "cam", "lens",
        )
        load_kw = {k: params[k] for k in load_keys if k in params}
        # Mirror process()'s decode/geometry defaults exactly — a batch of
        # the same params must render like per-image process() calls.
        load_kw.setdefault("half_size", True)
        load_kw.setdefault("lens_correction", True)
        load_kw.setdefault("max_scale", MAX_SCALE_DEFAULT)
        icc_transform = params.get("icc_transform")
        finish_kw = dict(
            icc_transform=None,  # baked into the device chain below
            canvas_mode=params.get("canvas_mode", "No"),
            canvas_scale=params.get("canvas_scale", 1.0),
            canvas_ratio=params.get("canvas_ratio", 1.0),
        )

        merged = dict(
            exp_kelvin=6500.0, tint=0.0, exp_comp=0.0, push_pull=0.0,
            color_masking=1.0, red_light=0.0, green_light=0.0,
            blue_light=0.0, projector_kelvin=6500.0, shadow_comp=0.0,
            sat_adjust=1.0, inversion_gamma=4.0, idealized_curve=False,
            inversion=False, white_balance=False, white_clip=False,
            gamma_func="sRGB", halation_intensity=1.0,
            halation_green_factor=0.4, highlight_burn=0.0, halation=True,
            halation_size=1.0, sharpness=True, sharpening_strength=0.0,
            sharpening_sigma=1.0, grain=2, grain_size=6.0, grain_sigma=0.4,
            burn_scale=50.0, chroma_nr=0, mtf_fidelity=False,
        )
        merged.update({k: v for k, v in params.items() if k in merged})
        bundle, prt_mode = self.load_film_bundle(negative_film, print_film, merged)

        # Decode per image. When an image needs no geometry/lens/NR work and
        # decodes to a plain Bayer mosaic, the FUSED path applies: demosaic +
        # camera matrix + exposure gain fold into the render program
        # (render_chain_from_mosaic) — the camera-RGB image never exists in
        # device memory. Everything else takes the
        # standard decoded-XYZ path. fused_decode=False opts out (e.g. to
        # reproduce the staged path bit-for-bit).
        fused_ok = bool(params.get("fused_decode", True)) and mesh is None
        buckets: dict[tuple, list[tuple[int, np.ndarray, tuple]]] = {}
        mosaic_buckets: dict[tuple, list[tuple]] = {}
        for idx, src in enumerate(srcs):
            fast, parsed = (
                self._try_load_mosaic(src, load_kw)
                if fused_ok
                else (None, None)
            )
            if fast is not None:
                mosaic, norm, pattern, cam, gain, crop = fast
                mosaic_buckets.setdefault(
                    (mosaic.shape, pattern, crop), []
                ).append((idx, mosaic, cam, gain, norm))
                continue
            xyz, orig_res, _m = self.load_image(
                parsed if parsed is not None else src, cache=False, **load_kw
            )
            arr = np.asarray(xyz)
            buckets.setdefault(arr.shape, []).append((idx, arr, orig_res))

        fw = float(params.get("frame_width", 36.0))
        fh = float(params.get("frame_height", 24.0))
        # ICC attaches to the bundle once (shape-independent); cfg gets the
        # flag per bucket below. Per-image grain keys are fold_in(base,
        # position-in-srcs): independent of how images bucket by shape, so a
        # render is deterministic across bucket compositions, and position 0
        # matches a single process() call with the same seed.
        bundle = dict(bundle)
        if icc_transform is not None:
            bundle["icc_u"], bundle["icc_v"], bundle["icc_w"] = self._icc_arrays(
                icc_transform
            )
        base_key = _jax.random.PRNGKey(seed)
        import dataclasses as _dc

        results: list = [None] * len(srcs)
        for shape, items in buckets.items():
            scale = max(shape[-2:]) / max(fw, fh)
            cfg = build_render_config(negative_film, print_film, prt_mode, scale, merged)
            if icc_transform is not None:
                cfg = _dc.replace(cfg, icc=True)
            # One jit wrapper per bucket (not per group): every group of the
            # same shape reuses the compiled program.
            fn = (
                sharded_batch_render(mesh, cfg)
                if mesh is not None
                else _jax.jit(batch_render_fn(cfg))
            )
            # Sub-batch so a bucket of 100x45MP frames never tries to stack
            # into one device array (~2GB of f32 inputs per group).
            img_bytes = int(np.prod(shape)) * 4
            group = max(1, int(2e9 // max(img_bytes, 1)))
            if mesh is not None:
                group = max(group, mesh.shape["batch"])
            for g0 in range(0, len(items), group):
                part = items[g0 : g0 + group]
                batch = jnp.asarray(np.stack([a for _, a, _ in part]))
                keys = jnp.stack(
                    [_jax.random.fold_in(base_key, idx) for idx, _, _ in part]
                )
                b = batch.shape[0]
                if mesh is not None:
                    per = mesh.shape["batch"]
                    pad = (-b) % per
                    if pad:
                        # Tile: pad may exceed b (e.g. 2 images on an 8-wide
                        # batch axis -> pad=6), so a single slice is short.
                        reps = -(-pad // b)
                        filler = jnp.concatenate([batch] * reps, axis=0)[:pad]
                        kfiller = jnp.concatenate([keys] * reps, axis=0)[:pad]
                        batch = jnp.concatenate([batch, filler], axis=0)
                        keys = jnp.concatenate([keys, kfiller], axis=0)

                if mesh is not None:
                    with mesh:
                        out = np.asarray(fn(batch, bundle, keys))[:b]
                else:
                    out = np.asarray(fn(batch, bundle, keys))
                for (idx, _, orig_res), img in zip(part, out):
                    results[idx] = self._finish(
                        img, orig_resolution=orig_res, **finish_kw
                    )

        # Fused-mosaic buckets: demosaic + camera matrix + exposure gain
        # inside the render program.
        from raw2film_tpu.pipeline.render import batch_mosaic_render_fn

        for (shape, pattern, crop), items in mosaic_buckets.items():
            out_shape = (crop[2], crop[3]) if crop is not None else shape
            scale = max(out_shape) / max(fw, fh)
            cfg = build_render_config(
                negative_film, print_film, prt_mode, scale, merged
            )
            if icc_transform is not None:
                cfg = _dc.replace(cfg, icc=True)
            img_bytes = int(np.prod(shape)) * 4 * 3
            group = max(1, int(2e9 // max(img_bytes, 1)))
            fn = _jax.jit(batch_mosaic_render_fn(cfg, pattern, crop))
            for g0 in range(0, len(items), group):
                part = items[g0 : g0 + group]
                mosaics = jnp.asarray(np.stack([m for _, m, *_ in part]))
                cams = jnp.asarray(np.stack([c for _, _, c, _, _ in part]))
                gains = jnp.asarray(np.stack([g for _, _, _, g, _ in part]))
                norms = jnp.asarray(np.stack([n for *_, n in part]))
                keys = jnp.stack(
                    [_jax.random.fold_in(base_key, idx) for idx, *_ in part]
                )
                out = np.asarray(fn(mosaics, cams, gains, bundle, keys, norms))
                for (idx, *_), img in zip(part, out):
                    results[idx] = self._finish(
                        img, orig_resolution=None, **finish_kw
                    )
        return results
