"""The fused device render chain: one jitted function, camera XYZ -> uint8.

This is the single pipeline that replaces BOTH reference engines
(CpuProcessor src/raw2film/cpu_processor.py:269-414 and the WGSL pass chain
gpu_processor.py:1695-1890). Stage order is the reference's spec:

    [chroma NR] -> input transform (WB + exposure matrix) -> [halation]
    -> log10 + H&D development + masking -> [MTF sharpness] -> [grain]
    -> [highlight burn] -> print/inversion chain -> display encode -> uint8

Everything is elementwise math, 3x3 channel matmuls, and separable convs in
planar (3, H, W) float32 — zero per-pixel gathers, so XLA fuses the chain
into a handful of HBM passes.

Static (recompile-triggering) configuration: image shape, stage toggles, and
kernel-shaping values (scale, halation size, grain size, chroma NR radius,
burn scale, gamma curve choice). Continuously varying film parameters
(matrices, curve constants, printer lights) travel in the ``FilmBundle``
pytree of arrays and never retrigger compilation — an interactive slider
re-jits only when it changes a kernel's shape, like the reference rebuilding
its numba kernels.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp

from raw2film_tpu.config import LOG10_EPS
from raw2film_tpu.film import chain as fchain
from raw2film_tpu.film.stock import FilmStock
from raw2film_tpu.ops import (
    burn as burn_ops,
    chroma_nr as nr_ops,
    fastmath as fm,
    grain as grain_ops,
    halation as hal_ops,
    mtf as mtf_ops,
)

Array = Any


# ---------------------------------------------------------------- bundles


@dataclass(frozen=True)
class RenderConfig:
    """Hashable static config — the jit cache key."""

    scale: float  # pixels per mm on film
    halation: bool = True
    halation_size: float = 1.0
    bw: bool = False
    sharpness: bool = True
    has_mtf: bool = True
    sharpening_strength: float = 0.0
    sharpening_sigma: float = 1.0
    grain: int = 2
    has_grain: bool = True
    grain_size_mm: float = 0.006
    grain_sigma: float = 0.4
    highlight_burn: bool = False
    burn_scale: float = 50.0
    chroma_nr: int = 0
    print_mode: str = "print"  # "print" | "inversion" | "direct"
    shadow_comp: bool = False
    sat_neutral: bool = True  # sat_adjust == 1.0 fast path
    gamma_func: str = "sRGB"
    mtf_key: tuple | None = None
    mtf_signed: bool = False  # r2f fidelity mode (``mtf_fidelity`` param):
    # build the MTF kernel WITHOUT the reference's np.abs() rectification,
    # restoring the adjacency-effect negative lobes so the applied response
    # tracks the tabulated datasheet curve (ops/mtf.py::mtf_kernel_layer).
    # Off by default — the goldens pin reference-parity output.
    icc: bool = False  # bundle carries a CP-factored ICC output LUT
    quantize: bool = True  # False: return the encoded float image instead
    # of uint8 — the fidelity gates compare in float, where a rounding
    # boundary can't alias f32-vs-f64 epsilon into a full 8-bit code


def make_film_bundle(
    neg_p: fchain.NegativeParams,
    prt_p: fchain.PrintParams,
    out_p: fchain.OutputParams,
    halation_intensity: float = 1.0,
    halation_green_factor: float = 0.3,
    highlight_burn: float = 0.0,
    d_ref_green: float = 1.0,
    grain_rms: float = 0.0,
    grain_shape: tuple = (1.0, 1.2, 0.15, 0.0, 4.0),
    sat: float = 1.0,
) -> dict:
    """Pack the calibrated chain into a pytree of device arrays (all traced:
    value changes do NOT recompile)."""

    def dev(a):
        return jnp.asarray(np.asarray(a, np.float32))

    return {
        "m_in": dev(neg_p.m_in),
        "flare": dev(neg_p.flare),
        "neg_curve": tuple(dev(c) for c in neg_p.curve),
        "mask": dev(neg_p.mask),
        "d_min": dev(neg_p.d_min.reshape(3, 1, 1)),
        "a": dev(prt_p.a),
        "log_e0": dev(prt_p.log_e0.reshape(3, 1, 1)),
        "prt_curve": tuple(dev(c) for c in prt_p.curve),
        "v": dev(prt_p.v),
        "d_offset": dev(prt_p.d_offset.reshape(3, 1, 1)),
        "vd_offset": dev(prt_p.vd_offset.reshape(3, 1, 1)),
        "shadow_comp": dev(prt_p.shadow_comp),
        "shadow_ref": dev(prt_p.shadow_ref),
        "to_display": dev(out_p.to_display),
        "white_gain": dev(out_p.white_gain.reshape(3, 1, 1)),
        "sat": dev(sat),
        "hal_intensity": dev(halation_intensity),
        "hal_green": dev(halation_green_factor),
        "highlight_burn": dev(highlight_burn),
        "d_ref_green": dev(d_ref_green),
        "grain_rms": dev(grain_rms),
        "grain_shape": dev(np.asarray(grain_shape, np.float32)),
    }


# ---------------------------------------------------------------- pieces


# exp2/log2 transcendental forms (ops/fastmath.py).
_softplus = fm.softplus


def _hd_density(log_e, curve):
    d_min, gamma, x_toe, x_sh, w_t, w_s = curve
    return d_min + gamma * (
        _softplus(log_e - x_toe, w_t) - _softplus(log_e - x_sh, w_s)
    )


def _mat(m, img):
    # HIGHEST precision: a default-precision f32 matmul may round its
    # inputs (TF32 keeps 10 mantissa bits — several 8-bit codes through the
    # chain). These 3x3 matmuls are bandwidth-bound, so exact f32 is free.
    return jnp.einsum(
        "ij,jhw->ihw", m, img, precision=jax.lax.Precision.HIGHEST
    )


# Channels travel as a TUPLE of (H, W) planes through the elementwise
# sections: a 3x3 matmul then lowers to fused scalar mul-adds (exact f32)
# instead of an einsum node that breaks XLA fusion into its own round trip
# through device memory.
# Stacking back to (3, H, W) happens only at conv-kernel boundaries.


def _matp(m, planes):
    return tuple(
        m[i, 0] * planes[0] + m[i, 1] * planes[1] + m[i, 2] * planes[2]
        for i in range(3)
    )


def _hd_plane(x, curve, c):
    d_min, gamma, x_toe, x_sh, w_t, w_s = curve
    return jnp.reshape(d_min, (3, -1))[c, 0] + jnp.reshape(gamma, (3, -1))[c, 0] * (
        _softplus(x - jnp.reshape(x_toe, (3, -1))[c, 0], jnp.reshape(w_t, (3, -1))[c, 0])
        - _softplus(x - jnp.reshape(x_sh, (3, -1))[c, 0], jnp.reshape(w_s, (3, -1))[c, 0])
    )


def _planes(img):
    return (img[0], img[1], img[2])


# ---------------------------------------------------------------- chain


def exposure_stage(xyz: Array, bundle: dict, cfg: RenderConfig) -> tuple:
    """[chroma NR] -> input transform: WB CAT + layer exposure matrix
    (+2^exp_comp folded in) -> planes of linear layer exposure."""
    img = xyz
    if cfg.chroma_nr:
        img = nr_ops.chroma_nr(img, cfg.chroma_nr)
    return tuple(jnp.maximum(q, 0.0) for q in _matp(bundle["m_in"], _planes(img)))


def halation_stage(ep: tuple, bundle: dict, cfg: RenderConfig) -> tuple:
    """Blur on the stacked image; the normalize-combine runs in planes so it
    fuses into the develop stage's elementwise pass."""
    g = bundle["hal_green"]
    factors = bundle["hal_intensity"] * (
        jnp.stack([jnp.ones_like(g), g, jnp.zeros_like(g)])
        if not cfg.bw
        else jnp.stack([g, g, g])
    )
    blur = hal_ops.halation_blur(jnp.stack(ep), cfg.scale, cfg.halation_size)
    return tuple(
        (ep[c] + factors[c] * blur[c]) / (1.0 + factors[c]) for c in range(3)
    )


def develop_stage(ep: tuple, bundle: dict) -> Array:
    """Log exposure -> status densities (+ masking coupling), (3, H, W)."""
    xp = tuple(
        fm.log10(jnp.maximum(ep[c] + bundle["flare"], LOG10_EPS))
        for c in range(3)
    )
    dm = jnp.reshape(bundle["d_min"], (3, -1))
    dp = tuple(
        _hd_plane(xp[c], bundle["neg_curve"], c) - dm[c, 0] for c in range(3)
    )
    dp = tuple(q + dm[c, 0] for c, q in enumerate(_matp(bundle["mask"], dp)))
    return jnp.stack(dp)


def sharpness_stage(d: Array, cfg: RenderConfig) -> Array:
    return mtf_ops.film_sharpness_from_key(
        d, cfg.mtf_key, cfg.scale, cfg.sharpening_strength,
        cfg.sharpening_sigma, signed=cfg.mtf_signed,
    )


def grain_stage(
    d: Array, bundle: dict, cfg: RenderConfig, noise_key: Array, row_offset=0
) -> Array:
    """density + amplitude(density) * hash grain field, clipped at 0."""
    peak, width, floor, d_lo, d_hi = (bundle["grain_shape"][i] for i in range(5))
    rng = jnp.maximum(d_hi - d_lo, 1e-3)
    pixel_um = 1000.0 / cfg.scale
    rms_eff = (bundle["grain_rms"] / 1000.0) * (48.0 / pixel_um)
    field = grain_ops.generate_grain_field(
        noise_key,
        d.shape[-2:],
        cfg.scale,
        cfg.grain_size_mm,
        cfg.grain_sigma,
        bw=cfg.grain == 1,
        row_offset=row_offset,
    )
    # KEEP IN SYNC: this amplitude curve also lives in
    # ops/grain.py::grain_amplitude_device (scale-unfolded form); both are
    # pinned against the float64 oracle, so a lone edit here fails those
    # pins rather than desyncing silently.
    t = (d - d_lo) / rng
    shape = floor + (1 - floor) * fm.expe(
        -0.5 * ((t - peak / rng * 0.5 - 0.25) / (width * 0.35)) ** 2
    )
    amp = rms_eff * shape
    if cfg.grain == 1:
        amp = jnp.broadcast_to(amp.mean(axis=0, keepdims=True), amp.shape)
    return jnp.maximum(d + amp * field, 0.0)


def burn_stage(
    d: Array, bundle: dict, cfg: RenderConfig, ref_hw=None, row_offset=None
) -> Array:
    return burn_ops.burn(
        d, bundle["d_ref_green"], bundle["highlight_burn"], cfg.burn_scale,
        ref_hw=ref_hw, row_offset=row_offset,
    )


def render_chain(
    xyz: Array,
    bundle: dict,
    cfg: RenderConfig,
    noise_key: Array,
    grain_row_offset=0,
    burn_ref_hw: tuple | None = None,
    input_is_exposure: bool = False,
) -> Array:
    """(3, H, W) float32 camera XYZ -> (3, H, W) uint8 encoded output.

    ``grain_row_offset`` (traced int ok) shifts the grain hash rows to
    global image coordinates — a row-sharded render reproduces the
    single-device grain field exactly; ``burn_ref_hw`` (static) pins the
    highlight-burn blur factor to the GLOBAL frame size so shards match
    the single-device factor (parallel/mesh.py halo path).
    ``input_is_exposure``: the input already IS the chain's exposure image
    (max(m_in @ xyz, 0) — the fused-demosaic path computes it inside the
    demosaic pass); skip chroma NR and the input transform.

    Each stage runs under a ``jax.named_scope`` of its name, so a profiler
    trace attributes device time to it."""
    if input_is_exposure:
        ep = _planes(xyz)
    else:
        with jax.named_scope("exposure"):
            ep = exposure_stage(xyz, bundle, cfg)
    if cfg.halation:
        with jax.named_scope("halation"):
            ep = halation_stage(ep, bundle, cfg)
    with jax.named_scope("develop"):
        d = develop_stage(ep, bundle)
    if cfg.sharpness and cfg.has_mtf and cfg.mtf_key is not None:
        with jax.named_scope("mtf"):
            d = sharpness_stage(d, cfg)
    if cfg.grain and cfg.has_grain:
        with jax.named_scope("grain"):
            d = grain_stage(d, bundle, cfg, noise_key, grain_row_offset)
    if cfg.highlight_burn:
        # Row-sharded renders (burn_ref_hw set) align the burn's low-res
        # grid to the GLOBAL frame via the shard's global row offset — the
        # same value the grain hash uses — so seams carry no one-cell glow
        # misalignment.
        with jax.named_scope("burn"):
            d = burn_stage(
                d, bundle, cfg, burn_ref_hw,
                grain_row_offset if burn_ref_hw is not None else None,
            )
    with jax.named_scope("print_tail"):
        return _print_tail(d, bundle, cfg)


def _print_tail(d: Array, bundle: dict, cfg: RenderConfig) -> Array:
    """The chain tail in planes: print/inversion/direct -> display encode
    -> [ICC LUT] -> uint8."""
    dp = _planes(d)
    if cfg.print_mode == "print":
        le0 = jnp.reshape(bundle["log_e0"], (3, -1))
        log_e = tuple(
            le0[c, 0] - q for c, q in enumerate(_matp(bundle["a"], dp))
        )
        d_pp = tuple(
            _hd_plane(log_e[c], bundle["prt_curve"], c) for c in range(3)
        )
    else:
        doff = jnp.reshape(bundle["d_offset"], (3, -1))
        d_pp = tuple(dp[c] - doff[c, 0] for c in range(3))
    vd = _matp(bundle["v"], d_pp)
    if cfg.shadow_comp:
        vd = tuple(
            q - bundle["shadow_comp"] * _softplus(q - bundle["shadow_ref"], 0.35)
            for q in vd
        )
    vdo = jnp.reshape(bundle["vd_offset"], (3, -1))
    lin = tuple(fm.pow10(-(vd[c] + vdo[c, 0])) for c in range(3))

    # Output encode.
    wg = jnp.reshape(bundle["white_gain"], (3, -1))
    rgbp = tuple(
        q * wg[c, 0] for c, q in enumerate(_matp(bundle["to_display"], lin))
    )
    if not cfg.sat_neutral:
        luma = 0.2126 * rgbp[0] + 0.7152 * rgbp[1] + 0.0722 * rgbp[2]
        rgbp = tuple(luma + bundle["sat"] * (q - luma) for q in rgbp)
    rgb = jnp.stack([fm.encode(q, cfg.gamma_func) for q in rgbp])
    if cfg.icc:
        # ICC display/softproof baked into a CP-factored LUT, applied in
        # float BEFORE quantization (reference: cpu_processor.py:255-263).
        from raw2film_tpu.ops.lut import apply_lut_3d_cp

        rgb = jnp.clip(
            apply_lut_3d_cp(
                rgb, bundle["icc_u"], bundle["icc_v"], bundle["icc_w"], scale=1.0
            ),
            0.0,
            1.0,
        )
    if not cfg.quantize:
        return rgb
    return jnp.round(rgb * 255.0).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("cfg",))
def render_jit(xyz: Array, bundle: dict, cfg: RenderConfig, noise_key: Array):
    return render_chain(xyz, bundle, cfg, noise_key)


@partial(jax.jit, static_argnames=("cfg", "pattern", "crop"))
def render_mosaic_jit(
    mosaic: Array,
    cam_to_xyz: Array,
    gain: Array,
    bundle: dict,
    cfg: RenderConfig,
    noise_key: Array,
    pattern: str,
    crop: tuple | None,
    norm: Array | None = None,
):
    """Single-image fused-mosaic render (module-level jit so repeated
    per-frame process() calls in a batch export reuse one compiled program;
    gain and the u16 normalization scalars are traced, so per-image
    exposure/black levels never retrigger compilation)."""
    return render_chain_from_mosaic(
        mosaic, cam_to_xyz, bundle, cfg, noise_key, pattern, gain, crop, norm
    )


def render_chain_from_mosaic(
    mosaic: Array,
    cam_to_xyz: Array,
    bundle: dict,
    cfg: RenderConfig,
    noise_key: Array,
    pattern: str = "RGGB",
    exposure_gain: float | Array = 1.0,
    crop: tuple | None = None,
    norm: Array | None = None,
) -> Array:
    """CFA mosaic -> rendered image in ONE program: fused demosaic + the
    full film chain, with the 3x3 camera matrix and scalar exposure gain
    folded algebraically into the chain's input-transform matrix
    (m_in' = m_in @ (gain * cam_to_xyz)) — the camera-RGB image never
    round-trips device memory between decode and render.

    The per-stage path (io.raw.decode_raw then render_chain) remains the
    interactive default: its decode result is cached across slider changes.
    This fused entry is the batch-export / benchmark configuration
    (reference's one-shot process(), src/raw2film/cpu_processor.py:269-414).
    """
    if cfg.chroma_nr != 0:
        # render_chain's chroma NR stage expects CIE XYZ, but the fused
        # path folds cam_to_xyz into m_in and hands render_chain the raw
        # camera RGB — NR on camera-RGB "chromaticities" would silently
        # diverge from the staged path. Processor gates this off
        # (_try_load_mosaic rejects chroma_nr); hold direct API callers to
        # the same contract instead of rendering something different.
        raise ValueError(
            "render_chain_from_mosaic does not support chroma_nr; decode "
            "to XYZ and use render_chain (the staged path) instead"
        )
    from raw2film_tpu.ops import demosaic as dm

    if norm is not None:
        # Raw u16 sensor codes normalize ON DEVICE: callers upload 2 bytes/
        # pixel instead of the 4-byte normalized f32 plane (45MP: 90 MB vs
        # 180 MB host->device). Same f32 ops as the host normalization
        # (io/dng decode path), so the result is bit-identical.
        black, inv_range = norm[0], norm[1]
        mosaic = jnp.clip(
            (mosaic.astype(jnp.float32) - black) * inv_range, 0.0, 1.0
        )
    b = dict(bundle)
    # HIGHEST precision on the 3x3 fold: a default-precision f32 matmul may
    # round its inputs (TF32), costing 8-bit codes through the chain; a 3x3
    # at full precision is free.
    b["m_in"] = jnp.matmul(
        bundle["m_in"],
        jnp.asarray(cam_to_xyz, jnp.float32) * exposure_gain,
        precision=jax.lax.Precision.HIGHEST,
    )
    # Input transform fused into the demosaic pass: the camera-RGB image
    # never exists in device memory (clip01 -> m_in -> max0 commute with
    # the static crop below, which keeps an odd-origin aspect crop while
    # the demosaic sees an even-aligned, Bayer-phase-preserving superset).
    with jax.named_scope("demosaic"):
        ep = dm.demosaic_exposure(mosaic, pattern, b["m_in"])
    if crop is not None:
        y0, x0, ch, cw = crop
        ep = ep[:, y0 : y0 + ch, x0 : x0 + cw]
    return render_chain(ep, b, cfg, noise_key, input_is_exposure=True)


def batch_mosaic_render_fn(cfg: RenderConfig, pattern: str, crop: tuple | None = None):
    """Batched fused-mosaic render: (B, H, W) u16 mosaics + per-image
    camera matrices, exposure gains and (black, inv_range) normalization
    pairs -> (B, 3, H, W) uint8, one device loop (lax.map, like
    batch_render_fn: one frame's temporaries live at a time)."""

    def fn(mosaics, cams, gains, bundle, keys, norms):
        def one(args):
            m, cam, g, k, nm = args
            return render_chain_from_mosaic(
                m, cam, bundle, cfg, k, pattern, g, crop, nm
            )

        return jax.lax.map(one, (mosaics, cams, gains, keys, norms))

    return fn


# ---------------------------------------------------------- config builder


def build_render_config(
    neg: FilmStock,
    prt: FilmStock | None,
    prt_mode: str,
    scale: float,
    merged: dict,
) -> RenderConfig:
    """Derive the static config from merged params (see params.merge_params)."""
    return RenderConfig(
        scale=float(scale),
        halation=bool(merged["halation"]),
        halation_size=float(merged["halation_size"]),
        bw=neg.is_bw,
        sharpness=bool(merged["sharpness"]),
        has_mtf=neg.mtf is not None,
        sharpening_strength=float(merged["sharpening_strength"]),
        sharpening_sigma=float(merged["sharpening_sigma"]),
        grain=int(merged["grain"]),
        has_grain=neg.rms_density is not None,
        grain_size_mm=float(merged["grain_size"]) / 1000.0,
        grain_sigma=float(merged["grain_sigma"]),
        highlight_burn=bool(merged["highlight_burn"])
        and (prt is not None or neg.density_measure in ("status_m", "bw")),
        burn_scale=float(merged["burn_scale"]),
        chroma_nr=int(merged["chroma_nr"]),
        print_mode=prt_mode,
        shadow_comp=bool(merged["shadow_comp"]),
        sat_neutral=float(merged["sat_adjust"]) == 1.0,
        gamma_func=str(merged["gamma_func"]),
        mtf_key=mtf_ops._hashable_mtf(neg.mtf) if neg.mtf is not None else None,
        mtf_signed=bool(merged.get("mtf_fidelity", False)),
    )
