"""Benchmark suite: the five BASELINE.json configs, one JSON line each.

Run on the GPU:  python benchmarks/run_configs.py [config_index ...]

Every timed call blocks on its full output (benchmarks/harness.py); the
script fails when JAX's default device is not a GPU, and prints the device
line (platform, device_kind, count, card name and power limit) first.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmarks import harness  # noqa: E402


def _timed(jfn, args, iters=6):
    """Median seconds per call, each blocked on its full output."""
    return harness.time_ms(jfn, *args, iters=iters)["median_ms"] / 1e3


def _setup(h, w, **kw):
    from __graft_entry__ import _build

    return _build(h, w, **kw)


def _input(h, w, seed=0):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    row = np.abs(rng.normal(0.25, 0.2, (3, 1, w))).astype(np.float32)
    col = np.abs(rng.normal(1.0, 0.3, (1, h, 1))).astype(np.float32)
    return jnp.asarray(row * col)


def config_0():
    """Single DNG -> demosaic + default negative -> sRGB (smoke path)."""
    import jax
    import jax.numpy as jnp

    from raw2film_tpu.ops.demosaic import demosaic_mhc
    from raw2film_tpu.pipeline.render import render_chain

    h, w = 4000, 6000  # 24MP mosaic
    bundle, cfg = _setup(h, w, grain=0, halation=False, sharpness=False, burn=0.0)
    mosaic = jnp.asarray(np.abs(np.random.default_rng(0).normal(0.2, 0.15, (h, w))).astype(np.float32))

    @jax.jit
    def run(mosaic, bundle, key):
        xyz = demosaic_mhc(mosaic, "RGGB")
        return render_chain(xyz, bundle, cfg, key)

    dt = _timed(run, (mosaic, bundle, jax.random.PRNGKey(0)), iters=60)
    return {"config": 0, "name": "demosaic + negative chain, 24MP", "ms": round(dt * 1e3, 2), "MP/s": round(h * w / 1e6 / dt, 1)}


def config_1():
    """Full negative+print chain with density curves @ 24MP."""
    import jax

    from raw2film_tpu.pipeline.render import render_chain

    h, w = 4000, 6000
    bundle, cfg = _setup(h, w, grain=0, halation=False, sharpness=False, burn=0.0)
    x = _input(h, w)

    @jax.jit
    def run(x, bundle, key):
        return render_chain(x, bundle, cfg, key)

    dt = _timed(run, (x, bundle, jax.random.PRNGKey(0)), iters=60)
    return {"config": 1, "name": "negative+print chain, 24MP", "ms": round(dt * 1e3, 1), "MP/s": round(h * w / 1e6 / dt, 1)}


def config_2():
    """Grain + MTF micro-contrast @ 45MP."""
    import jax

    from raw2film_tpu.pipeline.render import render_chain

    h, w = 5472, 8208
    bundle, cfg = _setup(h, w, grain=2, halation=False, sharpness=True, burn=0.0)
    x = _input(h, w)

    @jax.jit
    def run(x, bundle, key):
        return render_chain(x, bundle, cfg, key)

    dt = _timed(run, (x, bundle, jax.random.PRNGKey(0)))
    return {"config": 2, "name": "grain + MTF @ 45MP", "ms": round(dt * 1e3, 1), "MP/s": round(h * w / 1e6 / dt, 1)}


def config_3():
    """Halation fused into the full chain @ 45MP."""
    import jax

    from raw2film_tpu.pipeline.render import render_chain

    h, w = 5472, 8208
    bundle, cfg = _setup(h, w, grain=2, halation=True, sharpness=True, burn=0.3)
    x = _input(h, w)

    @jax.jit
    def run(x, bundle, key):
        return render_chain(x, bundle, cfg, key)

    dt = _timed(run, (x, bundle, jax.random.PRNGKey(0)))
    return {"config": 3, "name": "FULL chain (halation+MTF+grain+burn) @ 45MP", "ms": round(dt * 1e3, 1), "MP/s": round(h * w / 1e6 / dt, 1)}


def config_4():
    """Batch export at the spec scale: 45MP frames through the exact device
    call process_batch makes (batch_render_fn), in sub-groups of 4
    (processor.py's 2GB grouping rule); plus the simplified-preview
    downscale path."""
    import jax
    import jax.numpy as jnp

    from raw2film_tpu.parallel.mesh import batch_render_fn
    from raw2film_tpu.pipeline.render import render_chain

    h, w = 5472, 8208
    group, n_groups = 4, 4  # 16 x 45MP
    bundle, cfg = _setup(h, w, grain=2, halation=True, sharpness=True, burn=0.3)
    x = jnp.stack([_input(h, w, seed=i) for i in range(group)])
    run = jax.jit(batch_render_fn(cfg))

    keys = jax.random.split(jax.random.PRNGKey(0), group)
    dt_group = _timed(run, (x, bundle, keys), iters=n_groups)
    frames = group
    mp = h * w / 1e6

    # Simplified preview: 2MP, conv stages off (reference gui.py:2206-2209).
    ph, pw = 1152, 1728
    p_bundle, p_cfg = _setup(ph, pw, grain=0, halation=False, sharpness=False, burn=0.0)
    px = _input(ph, pw)
    preview = jax.jit(lambda px, b, k: render_chain(px, b, p_cfg, k))
    pdt = _timed(preview, (px, p_bundle, jax.random.PRNGKey(0)), iters=20)
    return {
        "config": 4,
        "name": f"batch export, sub-groups of {group}x45MP + simplified preview",
        "ms_per_frame": round(dt_group * 1e3 / frames, 1),
        "MP/s": round(frames * mp / dt_group, 1),
        "preview_ms": round(pdt * 1e3, 1),
        "preview_MP/s": round(ph * pw / 1e6 / pdt, 1),
    }


def config_5():
    """Device fidelity: the BASELINE dE gate measured ON DEVICE (the CI
    tests measure it on CPU) — bare negative+print chain vs float64 oracle.
    Guards the matmul-precision class of bug (a default-precision f32
    matmul may round its inputs to TF32 on the GPU; the chain's matmuls
    state Precision.HIGHEST)."""
    import sys

    sys.path.insert(0, "tests")
    import jax
    import jax.numpy as jnp

    from oracle.color_metrics import delta_e_2000_u8
    from raw2film_tpu.data import REC709_TO_XYZ
    from raw2film_tpu.film import chain as fchain
    from raw2film_tpu.film.loader import load_film_stocks
    from raw2film_tpu.pipeline.params import ImageParams, ProfileParams, merge_params
    from raw2film_tpu.pipeline.render import (
        build_render_config,
        make_film_bundle,
        render_jit,
    )

    stocks = load_film_stocks()
    neg, prt = stocks["Kodak Portra 400"], stocks["Fuji Crystal Archive Maxima"]
    h, w = 512, 768
    yy, xx = np.mgrid[0:h, 0:w]
    rgb = np.stack(
        [0.05 + 0.6 * xx / w, 0.05 + 0.5 * yy / h, 0.4 - 0.3 * xx / w]
    ).astype(np.float32)
    xyz = np.einsum("ij,jhw->ihw", REC709_TO_XYZ, np.clip(rgb, 0, 1)).astype(
        np.float32
    )
    neg_p = fchain.build_negative_params(neg)
    prt_p = fchain.build_print_params(neg, prt, neg_params=neg_p)
    out_p = fchain.build_output_params(neg, prt, prt_p, neg_p)
    want = fchain.render_oracle(xyz.astype(np.float64), neg_p, prt_p, out_p)
    want_u8 = np.round(np.clip(want, 0, 1) * 255).astype(np.uint8)
    merged = merge_params(ProfileParams(), ImageParams())
    merged.update(halation=False, sharpness=False, grain=0, highlight_burn=0.0)
    bundle = make_film_bundle(neg_p, prt_p, out_p)
    cfg = build_render_config(neg, prt, prt_p.mode, scale=w / 36, merged=merged)
    got = np.asarray(render_jit(jnp.asarray(xyz), bundle, cfg, jax.random.PRNGKey(0)))
    de = delta_e_2000_u8(got, want_u8)
    dn = np.abs(got.astype(np.int32) - want_u8.astype(np.int32))
    # The gate proper: pre-quantization float ΔE (a one-code flip at an
    # 8-bit rounding boundary is f32-vs-f64 epsilon, not color error).
    import dataclasses

    from oracle.color_metrics import delta_e_2000_float

    cfg_f = dataclasses.replace(cfg, quantize=False)
    got_f = np.asarray(
        render_jit(jnp.asarray(xyz), bundle, cfg_f, jax.random.PRNGKey(0))
    )
    de_f = delta_e_2000_float(got_f, np.clip(want, 0.0, 1.0))
    return {
        "config": 5,
        "name": "device fidelity: bare chain vs float64 oracle",
        "max_dE2000_float": round(float(de_f.max()), 4),
        "max_dE2000_u8": round(float(de.max()), 3),
        "p99_dE2000_u8": round(float(np.percentile(de, 99)), 3),
        "max_8bit_code_diff": int(dn.max()),
    }


ALL = [config_0, config_1, config_2, config_3, config_4, config_5]


def main():
    picks = [int(a) for a in sys.argv[1:]] or list(range(len(ALL)))
    devices = harness.init_gpu_backend()
    print(harness.device_line(devices), flush=True)
    for i in picks:
        print(json.dumps(ALL[i]()), flush=True)


if __name__ == "__main__":
    main()
