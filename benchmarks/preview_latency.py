"""Interactive preview latency: slider change -> JPEG frame, through the
ACTUAL viewer HTTP path.

The reference's hot loop is slider->pixels with request coalescing
(reference: src/raw2film/gui.py:2104-2129, 2166-2234 — a param change
schedules a render, the preview label repaints when it lands). Here the
same loop is: POST /api/params (merge+persist+render request) -> PreviewEngine
latest-wins mailbox -> device render -> JPEG encode -> GET /api/wait
long-poll resolves -> GET /api/frame.jpg.

Measures p50/p95/max request->frame-visible latency over N slider changes
at ~2MP with the decode cached (the steady-state editing case), for both
the simplified preview (grain/halation approximations the viewer uses
while dragging) and the full-pipeline preview.

Usage: python benchmarks/preview_latency.py [--n 30]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _get(url, timeout=120):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read()


def _post(url, doc, timeout=120):
    req = urllib.request.Request(
        url, data=json.dumps(doc).encode(), method="POST"
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=30)
    args = ap.parse_args()

    from raw2film_tpu.io.dng import write_dng
    from raw2film_tpu.viewer import ViewerState, make_handler

    folder = tempfile.mkdtemp(prefix="r2f_preview_bench_")
    # ~2MP source: the preview cap (PREVIEW_MAX_SCALE) renders ~2MP from
    # any larger frame, so a 1152x1728 source IS the steady-state preview
    # workload once decode is cached.
    rng = np.random.default_rng(0)
    h, w = 1152, 1728
    row = rng.integers(2000, 40000, (1, w))
    col = np.clip(rng.normal(1.0, 0.25, (h, 1)), 0.2, 2.0)
    write_dng(
        os.path.join(folder, "shot.dng"),
        (row * col).astype(np.uint16),
        white_level=60000,
    )

    state = ViewerState(folder)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def one_change(i, full):
        """POST a param change, long-poll until the frame lands, fetch it."""
        t0 = time.perf_counter()
        _post(
            base + "/api/params",
            {
                "i": 0,
                "full": full,
                "params": {"exp_comp": 0.01 * (i % 7), "tint": float(i % 5)},
            },
        )
        # /api/wait long-polls but returns (seq unchanged) on its own
        # timeout — the first render compiles first; re-poll until the
        # frame actually lands.
        deadline = time.time() + 600
        while True:
            _, body = _get(base + f"/api/wait?since={one_change.seq}")
            doc = json.loads(body)
            assert not doc.get("error"), doc
            if doc["seq"] > one_change.seq:
                break
            assert time.time() < deadline, "no frame within 600s"
        one_change.seq = doc["seq"]
        _, jpg = _get(base + f"/api/frame.jpg?seq={doc['seq']}")
        assert jpg[:2] == b"\xff\xd8"
        return time.perf_counter() - t0

    one_change.seq = 0
    results = {}
    for full, label in ((False, "simplified"), (True, "full")):
        one_change(999, full)  # compile + decode-cache warm (not timed)
        one_change(998, full)
        lat = sorted(one_change(i, full) for i in range(args.n))
        results[label] = {
            "p50_ms": round(lat[len(lat) // 2] * 1e3, 1),
            "p95_ms": round(lat[int(len(lat) * 0.95)] * 1e3, 1),
            "max_ms": round(lat[-1] * 1e3, 1),
            "n": args.n,
        }
        print(json.dumps({label: results[label]}), flush=True)

    httpd.shutdown()
    state.close()
    import shutil

    shutil.rmtree(folder, ignore_errors=True)


if __name__ == "__main__":
    main()
