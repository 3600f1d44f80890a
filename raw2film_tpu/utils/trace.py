"""Per-stage tracing/profiling.

The reference has only ad-hoc print timers (reference: src/raw2film/gui.py:
2342-2352, gui_objects.py:42,113). Here: a cheap stage timer that records a
rolling log and forwards to jax.profiler trace annotations when active, plus
an env-gated report.

Enable wall-clock printing with RAW2FILM_TRACE=1.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time

_LOG: dict[str, collections.deque] = collections.defaultdict(
    lambda: collections.deque(maxlen=64)
)
_ENABLED = os.environ.get("RAW2FILM_TRACE", "") not in ("", "0")


@contextlib.contextmanager
def stage_timer(name: str):
    """Times a stage; nests a jax.profiler annotation when profiling."""
    import jax.profiler

    t0 = time.perf_counter()
    with jax.profiler.TraceAnnotation(name):
        yield
    dt = time.perf_counter() - t0
    _LOG[name].append(dt)
    if _ENABLED:
        print(f"[trace] {name}: {dt * 1e3:.1f} ms")


def stage_stats() -> dict[str, dict]:
    """name -> {count, mean_ms, last_ms} across recorded stages."""
    out = {}
    for name, samples in _LOG.items():
        if samples:
            out[name] = {
                "count": len(samples),
                "mean_ms": sum(samples) / len(samples) * 1e3,
                "last_ms": samples[-1] * 1e3,
            }
    return out


def reset_stats() -> None:
    _LOG.clear()
