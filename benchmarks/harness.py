"""Shared device checks and timer for the chip-side scripts (chip_smoke.py,
bench.py, benchmarks/run_configs.py, benchmarks/stage_breakdown.py).

Every script that reports a device number calls :func:`require_gpu` first
(no CPU fallback: a number from another backend is not a GPU number), prints
:func:`device_line` once, and times with :func:`time_ms`, which blocks on
the whole output of every call.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np

GPU_PLATFORM = "gpu"


class NoGpuError(RuntimeError):
    """JAX's default device is not a GPU."""


def require_gpu(devices) -> None:
    """Raise NoGpuError unless ``devices[0]`` is a GPU."""
    if not devices:
        raise NoGpuError("JAX reports no devices")
    platform = devices[0].platform
    if platform != GPU_PLATFORM:
        raise NoGpuError(
            f"default JAX device is {platform!r} ({devices[0].device_kind}), "
            "not a GPU; this script measures the GPU only"
        )


def init_gpu_backend(with_cpu: bool = False):
    """Initialize JAX on the CUDA backend (plus the CPU backend when a
    comparison against it is needed) and return ``jax.devices()`` after
    :func:`require_gpu`. Raises NoGpuError when no GPU backend starts."""
    import jax

    jax.config.update("jax_platforms", "cuda,cpu" if with_cpu else "cuda")
    try:
        devices = jax.devices()
    except (RuntimeError, AssertionError) as e:
        # RuntimeError: the CUDA plugin failed to start; AssertionError:
        # no CUDA plugin is installed, so no backend initialized at all.
        raise NoGpuError(f"no GPU backend: {e!r}") from e
    require_gpu(devices)
    return devices


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them, one line
    per card joined by ' | '. Raises when nvidia-smi fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=30,
    ).stdout
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    if not lines:
        raise RuntimeError("nvidia-smi listed no GPU")
    return " | ".join(lines)


def device_summary(devices) -> dict:
    """The device as JAX reports it: platform, device_kind and count."""
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def device_line(devices) -> str:
    d = device_summary(devices)
    return (
        f"device platform={d['platform']} kind={d['kind']} count={d['count']}"
        f" card={card_line()}"
    )


def block(out):
    """Block until every array leaf of ``out`` is computed on the device."""
    import jax

    return jax.block_until_ready(out)


def time_ms(fn, *args, iters: int = 5, warmup: int = 1) -> dict:
    """Call ``fn(*args)`` ``warmup`` times, then ``iters`` times, each call
    timed on the host clock until its full output is ready on the device.
    Returns min/median/max milliseconds and the per-call list."""
    for _ in range(warmup):
        block(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        block(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return {
        "min_ms": float(np.min(times)),
        "median_ms": float(np.median(times)),
        "max_ms": float(np.max(times)),
        "ms": times,
    }


def on_platform(arr, platform: str = GPU_PLATFORM) -> bool:
    """True when every shard of the jax.Array ``arr`` lives on ``platform``."""
    return all(d.platform == platform for d in arr.devices())


def peak_bytes_in_use(device) -> int | None:
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use")
