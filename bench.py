"""Headline benchmark: a 45 MP Bayer mosaic through the full negative->print
chain (fused demosaic + halation + MTF + grain + highlight burn) on one GPU.

Usage: python bench.py [--iters 10]

Prints the device line (platform, device_kind, count, card name and power
limit) and then ONE JSON line. Each timed call blocks on the full uint8
output (benchmarks/harness.py); compilation is excluded and reported
separately. Fails when JAX's default device is not a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from __graft_entry__ import _build  # noqa: E402
from benchmarks import harness  # noqa: E402
from benchmarks.stage_breakdown import H, W, synthetic_mosaic  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="45 MP full-chain benchmark (GPU)")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    try:
        devices = harness.init_gpu_backend()
    except harness.NoGpuError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    print(harness.device_line(devices), flush=True)

    import jax
    import jax.numpy as jnp

    from raw2film_tpu.data import REC709_TO_XYZ
    from raw2film_tpu.pipeline.render import render_chain_from_mosaic

    bundle, cfg = _build(H, W)
    cam = jnp.asarray(REC709_TO_XYZ, jnp.float32)
    mosaic = jnp.asarray(synthetic_mosaic(H, W))
    norm = jnp.asarray([0.0, 1.0 / 60000.0], jnp.float32)
    key = jax.random.PRNGKey(0)
    run = jax.jit(
        lambda m, b, k, nm: render_chain_from_mosaic(m, cam, b, cfg, k, "RGGB", 1.0, None, nm)
    )
    t0 = time.perf_counter()
    compiled = run.lower(mosaic, bundle, key, norm).compile()
    compile_s = time.perf_counter() - t0
    t = harness.time_ms(compiled, mosaic, bundle, key, norm, iters=args.iters)
    mp = H * W / 1e6
    print(
        json.dumps(
            {
                "metric": "45MP mosaic->print chain (demosaic+halation+MTF+grain+burn), one GPU",
                "value": mp / (t["median_ms"] / 1e3),
                "unit": "MP/s",
                "device": harness.device_summary(devices),
                "detail": {
                    "ms_per_frame_median": t["median_ms"],
                    "ms_per_frame_min": t["min_ms"],
                    "ms_per_frame_max": t["max_ms"],
                    "iters": args.iters,
                    "compile_s": compile_s,
                    "megapixels": mp,
                    "frame": [H, W],
                    "peak_bytes_in_use": harness.peak_bytes_in_use(devices[0]),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
