"""Device time of each chain stage at 45 MP, each stage jitted on its own.

Usage: python benchmarks/stage_breakdown.py [--iters 5] [--trace DIR]

Each stage of the fused-mosaic render (demosaic + input transform,
halation, develop, MTF, grain, highlight burn, print tail) is compiled as
its own program on realistic inputs and timed with the shared
block-until-ready timer (benchmarks/harness.py). The whole program is
timed as well: the stage sum exceeds it by what XLA fuses across stage
boundaries. With ``--trace DIR`` one call of the whole program is traced with
jax.profiler into DIR and its device time is listed by HLO op (set
``XLA_FLAGS=--xla_gpu_enable_command_buffer=`` for per-fusion names).
Fails off the GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from __graft_entry__ import _build  # noqa: E402
from benchmarks import harness  # noqa: E402

H, W = 5504, 8256  # Nikon D850 / Z7 sensor, 45.4 MP


def synthetic_mosaic(h: int, w: int, seed: int = 0) -> np.ndarray:
    """u16 Bayer mosaic: smooth gradients, texture and clipped highlights
    (so halation and burn have work), built in bulk from ``seed``."""
    rng = np.random.default_rng(seed)
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    xx = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    base = 0.08 + 0.35 * xx + 0.2 * yy
    tex = rng.random((h // 8 + 1, w // 8 + 1), dtype=np.float32)
    tex = np.repeat(np.repeat(tex, 8, 0), 8, 1)[:h, :w]
    img = base * (0.7 + 0.6 * tex)
    # A few bright discs: specular highlights above clip.
    for cy, cx, r in ((0.3, 0.25, 0.04), (0.6, 0.7, 0.06), (0.8, 0.4, 0.02)):
        d2 = (yy - cy) ** 2 + ((xx - cx) * w / h) ** 2
        img = np.where(d2 < r * r, 1.0, img)
    return (np.clip(img, 0.0, 1.0) * 60000.0).astype(np.uint16)


def synthetic_xyz(h: int, w: int, seed: int = 0) -> np.ndarray:
    """(3, H, W) float32 XYZ scene of the same construction as
    :func:`synthetic_mosaic`, with a colour tint that varies across it."""
    from raw2film_tpu.data import REC709_TO_XYZ

    g = synthetic_mosaic(h, w, seed).astype(np.float32) / 60000.0
    xx = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    rgb = np.stack([g * (0.6 + 0.8 * xx), g, g * (1.4 - 0.8 * xx)])
    return np.einsum("ij,jhw->ihw", REC709_TO_XYZ.astype(np.float32), rgb)


def stage_times(h: int = H, w: int = W, iters: int = 5) -> dict:
    """name -> timing dict (harness.time_ms) for every stage and the whole
    program."""
    import jax
    import jax.numpy as jnp

    from raw2film_tpu.data import REC709_TO_XYZ
    from raw2film_tpu.ops import demosaic as dm
    from raw2film_tpu.pipeline import render as R

    bundle, cfg = _build(h, w)
    cam = jnp.asarray(REC709_TO_XYZ, jnp.float32)
    mosaic = jnp.asarray(synthetic_mosaic(h, w))
    norm = jnp.asarray([0.0, 1.0 / 60000.0], jnp.float32)
    key = jax.random.PRNGKey(0)
    m_in = jnp.matmul(bundle["m_in"], cam, precision=jax.lax.Precision.HIGHEST)

    @jax.jit
    def demosaic(mosaic, norm):
        x = jnp.clip((mosaic.astype(jnp.float32) - norm[0]) * norm[1], 0.0, 1.0)
        return dm.demosaic_exposure(x, "RGGB", m_in)

    halation = jax.jit(lambda ep, b: jnp.stack(R.halation_stage(R._planes(ep), b, cfg)))
    develop = jax.jit(lambda ep, b: R.develop_stage(R._planes(ep), b))
    mtf = jax.jit(lambda d: R.sharpness_stage(d, cfg))
    grain = jax.jit(lambda d, b, k: R.grain_stage(d, b, cfg, k))
    burn = jax.jit(lambda d, b: R.burn_stage(d, b, cfg))
    tail = jax.jit(lambda d, b: R._print_tail(d, b, cfg))
    full = jax.jit(
        lambda m, b, k, nm: R.render_chain_from_mosaic(
            m, cam, b, cfg, k, "RGGB", 1.0, None, nm
        )
    )

    ep = harness.block(demosaic(mosaic, norm))
    ep_h = harness.block(halation(ep, bundle))
    d = harness.block(develop(ep_h, bundle))
    out = {}
    for name, fn, args in (
        ("demosaic", demosaic, (mosaic, norm)),
        ("halation", halation, (ep, bundle)),
        ("develop", develop, (ep_h, bundle)),
        ("mtf", mtf, (d,)),
        ("grain", grain, (d, bundle, key)),
        ("burn", burn, (d, bundle)),
        ("print_tail", tail, (d, bundle)),
        ("full", full, (mosaic, bundle, key, norm)),
    ):
        out[name] = harness.time_ms(fn, *args, iters=iters)
    stage_sum = sum(
        out[k]["median_ms"]
        for k in ("demosaic", "halation", "develop", "mtf", "grain", "burn", "print_tail")
    )
    out["stage_sum"] = {"median_ms": stage_sum}
    return out


def device_time_by_op(xplane_path: str, top: int = 15) -> dict:
    """{device line: {"busy_ns", "top_ops": [(hlo_op, ns), ...]}} for the
    GPU planes of a jax.profiler trace. Run with
    ``XLA_FLAGS=--xla_gpu_enable_command_buffer=`` or the whole program
    shows as one ``command_buffer`` op."""
    from jax.profiler import ProfileData

    out = {}
    for plane in ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            by_op: dict = {}
            busy = 0
            for ev in line.events:
                op = dict(ev.stats).get("hlo_op") or ev.name
                by_op[op] = by_op.get(op, 0) + ev.duration_ns
                busy += ev.duration_ns
            out[f"{plane.name}/{line.name}"] = {
                "busy_ns": busy,
                "top_ops": sorted(by_op.items(), key=lambda kv: -kv[1])[:top],
            }
    return out


def trace_full(h: int, w: int, out_dir: str) -> dict:
    """Trace one warm call of the full fused-mosaic program; return
    device_time_by_op of the written trace."""
    import glob

    import jax
    import jax.numpy as jnp

    from raw2film_tpu.data import REC709_TO_XYZ
    from raw2film_tpu.pipeline import render as R

    bundle, cfg = _build(h, w)
    cam = jnp.asarray(REC709_TO_XYZ, jnp.float32)
    mosaic = jnp.asarray(synthetic_mosaic(h, w))
    norm = jnp.asarray([0.0, 1.0 / 60000.0], jnp.float32)
    key = jax.random.PRNGKey(0)
    full = jax.jit(
        lambda m, b, k, nm: R.render_chain_from_mosaic(
            m, cam, b, cfg, k, "RGGB", 1.0, None, nm
        )
    )
    harness.block(full(mosaic, bundle, key, norm))
    jax.profiler.start_trace(out_dir)
    harness.block(full(mosaic, bundle, key, norm))
    jax.profiler.stop_trace()
    paths = sorted(glob.glob(os.path.join(out_dir, "**", "*.xplane.pb"), recursive=True))
    return device_time_by_op(paths[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--trace", metavar="DIR", help="trace one full-program call into DIR")
    args = ap.parse_args(argv)
    h, w = H, W
    devices = harness.init_gpu_backend()
    print(harness.device_line(devices), flush=True)
    for name, t in stage_times(h, w, args.iters).items():
        print(json.dumps({"stage": name, "hw": [h, w], **t}), flush=True)
    if args.trace:
        for line, rec in trace_full(h, w, args.trace).items():
            print(json.dumps({"trace_line": line, **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
