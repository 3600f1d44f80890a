"""Smoke run of the RAW -> film chain on the GPU, through the user entry points.

Usage:
    python chip_smoke.py                # one card: full-res, export, preview, fidelity
    python chip_smoke.py --four-cards   # four cards: the sharded paths only

Phases (one process, one card):

1. full_res — a 45.4 MP Bayer DNG at the Nikon D850/Z7 sensor geometry
   (8256x5504) through ``Processor().process(..., half_size=False)`` on the
   fused mosaic path with halation, MTF, grain=2 and highlight burn on:
   device ms per frame (warm, blocked on the full uint8 output), compile
   seconds, compiled temp bytes, peak device bytes, and each stage's time
   compiled on its own (benchmarks/stage_breakdown.py).
2. export — three such files through the CLI's BatchRunner path with
   half-size decode and the 400 px/mm cap, to JPEG with EXIF (to .npy
   frames when Pillow is absent).
3. preview — slider changes through ``PreviewEngine`` at ~2 MP, simplified
   and full; p50 latency.
4. fidelity — (a) the bare chain at 45 MP against the float64 oracle
   (``film.chain.render_oracle``) on every 16th row, in float ΔE2000;
   (b) the full effects chain on a 1024-row full-width band, GPU against
   the same jitted program on the CPU backend, in 8-bit codes.

``--four-cards`` runs only: four 45 MP frames through
``Processor.process_batch(mesh=make_mesh(4))`` against their single-card
renders, and one frame on the halo space path (``space=4``) against its
unsharded render.

Every result line names the card (nvidia-smi name and power limit). The
last line is one JSON object, printed only when every phase passed. The
script exits non-zero without it when JAX has no GPU or any phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import queue
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

H, W = 5504, 8256  # Nikon D850 / Z7: 8256 x 5504, 45.4 MP
NEG, PRT = "Kodak Portra 400", "Fuji Crystal Archive Maxima"
EFFECTS = dict(halation=True, sharpness=True, grain=2, highlight_burn=0.5)
EXPORT_FILES = 3
EXPORT_MAX_SCALE = 400.0  # px/mm: the CLI's default cap (cli.py)
PREVIEW_MAX_SCALE = 48.0  # px/mm -> 1728 x 1152 = 2.0 MP
PREVIEW_CHANGES = 8
TIMED_ITERS = 5

# Fidelity limits.
BARE_ROW_STRIDE = 16
BARE_DE_MAX = 0.5  # float ΔE2000, strict <
BAND_ROWS = 1024
BAND_MARGIN = 64  # rows left out at each band edge
BAND_CODE_MAX = 2
BAND_WITHIN1_MIN = 0.999
SHARD_CODE_MAX = 1
SEAM_MARGIN = 12  # frame-edge rows left out of the space-path comparison

PHASES = ("full_res", "export", "preview", "fidelity")
FOUR_CARD_PHASES = ("four_cards",)


def select_phases(four_cards: bool) -> tuple:
    return FOUR_CARD_PHASES if four_cards else PHASES


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="RAW -> film chain smoke run on the GPU")
    ap.add_argument(
        "--four-cards",
        action="store_true",
        help="run only the four-card sharded paths (needs 4 GPUs)",
    )
    return ap.parse_args(argv)


def result_line(device: dict) -> str:
    """The final line: {"ok": true, "device": {platform, kind, count}}."""
    return json.dumps(
        {
            "ok": True,
            "device": {
                "platform": device["platform"],
                "kind": device["kind"],
                "count": device["count"],
            },
        }
    )


def code_diff_stats(a: np.ndarray, b: np.ndarray) -> dict:
    """Largest absolute 8-bit code difference and the share of values
    within one code."""
    d = np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32))
    return {"max_code": int(d.max()), "within1": float(np.mean(d <= 1))}


def passes(value: float, limit: float, op: str) -> bool:
    """``value op limit`` for op in '<', '<=', '>='."""
    if op == "<":
        return value < limit
    if op == "<=":
        return value <= limit
    if op == ">=":
        return value >= limit
    raise ValueError(f"unknown comparison {op!r}")


class Report:
    """Result lines, each tagged with the card, and the failed checks."""

    def __init__(self, card: str, out=None):
        self.card = card
        self.out = out or sys.stdout
        self.failures: list[str] = []

    def line(self, phase: str, **fields) -> None:
        body = " ".join(f"{k}={v}" for k, v in fields.items())
        print(f"{phase}: {body} | card: {self.card}", file=self.out, flush=True)

    def check(self, phase: str, name: str, value, limit, op: str) -> bool:
        ok = passes(value, limit, op)
        self.line(
            phase, check=name, value=value, limit=f"{op} {limit}",
            result="pass" if ok else "FAIL",
        )
        if not ok:
            self.failures.append(f"{phase}.{name}: {value} not {op} {limit}")
        return ok

    def require(self, phase: str, name: str, cond: bool, detail="") -> None:
        self.line(phase, check=name, result="pass" if cond else "FAIL", detail=detail)
        if not cond:
            self.failures.append(f"{phase}.{name}: {detail}")


# ------------------------------------------------------------------ inputs


def write_frames(directory: str, n: int, h: int, w: int) -> list[str]:
    """n synthetic 45 MP RGGB DNGs (seeds 0..n-1)."""
    from benchmarks.stage_breakdown import synthetic_mosaic
    from raw2film_tpu.io.dng import write_dng

    os.makedirs(directory, exist_ok=True)
    paths = []
    for i in range(n):
        p = os.path.join(directory, f"frame{i}.dng")
        write_dng(p, synthetic_mosaic(h, w, seed=i), white_level=65535, model="D850-size")
        paths.append(p)
    return paths


class _Capture:
    """Records the arguments of the fused-mosaic render program while
    Processor.process runs, so the same compiled program can be timed."""

    def __init__(self):
        from raw2film_tpu.pipeline import render as R

        self.module = R
        self.real = R.render_mosaic_jit
        self.args = None

    def __enter__(self):
        def spy(*args):
            self.args = args
            return self.real(*args)

        self.module.render_mosaic_jit = spy
        return self

    def __exit__(self, *exc):
        self.module.render_mosaic_jit = self.real


class _CompileClock:
    """Sums JAX's backend compile durations while active."""

    def __init__(self):
        import jax

        self.seconds = 0.0
        self.active = False
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if self.active and event == "/jax/core/compile/backend_compile_duration":
            self.seconds += duration

    @contextlib.contextmanager
    def measuring(self):
        self.active = True
        try:
            yield
        finally:
            self.active = False


# ------------------------------------------------------------------ phases


def phase_full_res(rep: Report, ctx: dict) -> None:
    import jax

    from benchmarks import harness
    from benchmarks.stage_breakdown import stage_times
    from raw2film_tpu.pipeline.processor import Processor

    dng = ctx["frames"][0]
    proc = Processor()
    clock = ctx["compile_clock"]
    t0 = time.perf_counter()
    with clock.measuring(), _Capture() as cap:
        img = proc.process(dng, NEG, print_film=PRT, half_size=False, max_scale=None, **EFFECTS)
    first_s = time.perf_counter() - t0
    rep.require("full_res", "fused_mosaic_path", cap.args is not None, "render_mosaic_jit called")
    if cap.args is None:
        return
    real = cap.real
    out = harness.block(real(*cap.args))
    rep.require(
        "full_res", "output_on_gpu", harness.on_platform(out),
        f"devices={sorted(str(d) for d in out.devices())}",
    )
    rep.require(
        "full_res", "output_shape", out.shape == (3, H, W) and out.dtype == np.uint8,
        f"{out.shape} {out.dtype}",
    )
    host = np.asarray(out)
    rep.require(
        "full_res", "process_equals_program",
        np.array_equal(host.transpose(1, 2, 0), img), "Processor.process output",
    )
    mean = float(host.mean())
    rep.require("full_res", "plausible_mean", 10.0 < mean < 245.0, f"mean={mean}")

    t = harness.time_ms(lambda: real(*cap.args), iters=TIMED_ITERS)
    mem = real.lower(*cap.args).compile().memory_analysis()
    warm_t0 = time.perf_counter()
    proc.process(dng, NEG, print_film=PRT, half_size=False, max_scale=None, **EFFECTS)
    warm_process_ms = (time.perf_counter() - warm_t0) * 1e3
    rep.line(
        "full_res",
        frame=f"{H}x{W}",
        ms_per_frame_median=t["median_ms"],
        ms_per_frame_min=t["min_ms"],
        ms_all=t["ms"],
        compile_s=clock.seconds,
        first_process_s=first_s,
        warm_process_ms=warm_process_ms,
        temp_bytes=getattr(mem, "temp_size_in_bytes", None),
        argument_bytes=getattr(mem, "argument_size_in_bytes", None),
        output_bytes=getattr(mem, "output_size_in_bytes", None),
        peak_bytes_in_use=harness.peak_bytes_in_use(jax.devices()[0]),
        cache_dir=jax.config.jax_compilation_cache_dir,
    )
    del out, host, img
    for name, st in stage_times(H, W, TIMED_ITERS).items():
        rep.line("stage", name=name, ms_median=st["median_ms"], ms_min=st.get("min_ms"))


def phase_export(rep: Report, ctx: dict) -> None:
    import importlib.util

    from raw2film_tpu.io.dng import read_raw
    from raw2film_tpu.pipeline.batch import BatchRunner
    from raw2film_tpu.pipeline.processor import Processor

    src_dir = os.path.dirname(ctx["frames"][0])
    out_dir = os.path.join(ctx["workdir"], "export_out")
    files = ctx["frames"][:EXPORT_FILES]
    have_pillow = importlib.util.find_spec("PIL") is not None
    t0 = time.perf_counter()
    if have_pillow:
        from raw2film_tpu import cli

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([src_dir, "-o", out_dir, "--jobs", str(EXPORT_FILES)])
        wall = time.perf_counter() - t0
        rep.require("export", "cli_exit_code", rc == 0, f"rc={rc} {buf.getvalue()[-300:]!r}")
        from PIL import Image

        outs = sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else []
        sizes = []
        for name in outs:
            with Image.open(os.path.join(out_dir, name)) as im:
                sizes.append(im.size)
                exif_ok = bool(im.getexif())
        rep.require("export", "jpegs_written", len(outs) == len(files), f"{outs}")
        rep.require("export", "jpeg_size", sizes and all(s == (W // 2, H // 2) for s in sizes), f"{sizes}")
        rep.require("export", "exif", bool(outs) and exif_ok, "EXIF block present")
    else:
        rep.line("export", pillow="absent", note="JPEG encode skipped; uint8 frames saved with numpy (host step)")
        proc = Processor()
        os.makedirs(out_dir, exist_ok=True)

        def process(payload, **_):
            return proc.process(
                payload, NEG, print_film=PRT, half_size=True, max_scale=EXPORT_MAX_SCALE
            )

        def export(image, src):
            dst = os.path.join(out_dir, os.path.basename(src) + ".npy")
            np.save(dst, image)
            return dst

        runner = BatchRunner(process, export, decode_fn=lambda s, **_: read_raw(s), workers=EXPORT_FILES)
        results = runner.run([(f, {}) for f in files])
        wall = time.perf_counter() - t0
        rep.require("export", "all_ok", all(r.ok for r in results), f"{[r.error for r in results if not r.ok]}")
        shapes = [np.load(r.dst).shape for r in results if r.ok]
        rep.require("export", "frame_size", shapes and all(s == (H // 2, W // 2, 3) for s in shapes), f"{shapes}")
    rep.line(
        "export", files=len(files), wall_s=wall, frames_per_min=len(files) / wall * 60.0,
        half_size=True, max_scale=EXPORT_MAX_SCALE, note="wall includes compile",
    )


def phase_preview(rep: Report, ctx: dict) -> None:
    from raw2film_tpu.pipeline.preview import PreviewEngine
    from raw2film_tpu.pipeline.processor import Processor

    frames: queue.Queue = queue.Queue()
    engine = PreviewEngine(
        Processor(),
        on_frame=lambda img, hist: frames.put(("frame", img)),
        on_error=lambda e: frames.put(("error", e)),
    )
    try:
        for mode, full in (("simplified", False), ("full", True)):
            lat, shape = [], None
            for i in range(PREVIEW_CHANGES + 1):  # change 0 compiles
                t0 = time.perf_counter()
                engine.request(
                    ctx["frames"][0], full_preview=full, negative_film=NEG,
                    print_film=PRT, max_scale=PREVIEW_MAX_SCALE,
                    exp_comp=0.1 * i, **(EFFECTS if full else {}),
                )
                kind, val = frames.get(timeout=900)
                if kind == "error":
                    raise val
                if i:
                    lat.append((time.perf_counter() - t0) * 1e3)
                shape = val.shape
            rep.line(
                "preview", mode=mode, frame=f"{shape[1]}x{shape[0]}",
                p50_ms=float(np.median(lat)), max_ms=float(np.max(lat)), changes=len(lat),
            )
    finally:
        engine.close()


def phase_fidelity(rep: Report, ctx: dict) -> None:
    import dataclasses

    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _build
    from benchmarks import harness
    from benchmarks.stage_breakdown import synthetic_xyz
    from raw2film_tpu.film import chain as fchain
    from raw2film_tpu.film.loader import load_film_stocks
    from raw2film_tpu.pipeline.render import render_jit

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from oracle.color_metrics import delta_e_2000_float

    bundle, cfg = _build(H, W)
    key = jax.random.PRNGKey(0)
    # The oracle's parameters, built independently of the bundle.
    stocks = load_film_stocks()
    neg, prt = stocks[NEG], stocks[PRT]
    neg_p = fchain.build_negative_params(neg)
    prt_p = fchain.build_print_params(neg, prt, neg_params=neg_p)
    out_p = fchain.build_output_params(neg, prt, prt_p, neg_p)

    # (a) Bare chain at 45 MP: pointwise, so every 16th row stands for all.
    rng = np.random.default_rng(7)
    from raw2film_tpu.data import REC709_TO_XYZ

    rgb = rng.random((3, H, W), dtype=np.float32) * 0.95 + 0.01
    xyz = np.einsum("ij,jhw->ihw", REC709_TO_XYZ.astype(np.float32), rgb)
    bare = dataclasses.replace(
        cfg, halation=False, sharpness=False, grain=0, highlight_burn=False, quantize=False
    )
    got = render_jit(jnp.asarray(xyz), bundle, bare, key)
    rep.require("fidelity", "bare_on_gpu", harness.on_platform(got), "render_jit output")
    got_rows = np.asarray(got[:, ::BARE_ROW_STRIDE])
    del got
    want = fchain.render_oracle(xyz[:, ::BARE_ROW_STRIDE].astype(np.float64), neg_p, prt_p, out_p)
    de = delta_e_2000_float(got_rows, np.clip(want, 0.0, 1.0))
    rep.line(
        "fidelity", test="bare_chain_vs_float64_oracle", frame=f"{H}x{W}",
        rows_compared=got_rows.shape[1], de2000_max=float(de.max()),
        de2000_p99=float(np.percentile(de, 99)),
    )
    rep.check("fidelity", "bare_de2000_max", float(de.max()), BARE_DE_MAX, "<")
    del xyz, rgb

    # (b) Full effects chain on a full-width band at the 45 MP frame's scale:
    # GPU against the same jitted program on the CPU backend.
    band = synthetic_xyz(BAND_ROWS, W, seed=3)
    gpu_out = render_jit(jnp.asarray(band), bundle, cfg, key)
    rep.require("fidelity", "band_on_gpu", harness.on_platform(gpu_out), "render_jit output")
    cpu = jax.devices("cpu")[0]
    cpu_out = render_jit(
        jax.device_put(band, cpu), jax.device_put(bundle, cpu), cfg, jax.device_put(key, cpu)
    )
    rep.require("fidelity", "band_reference_on_cpu", harness.on_platform(cpu_out, "cpu"), "reference")
    a = np.asarray(gpu_out)[:, BAND_MARGIN:-BAND_MARGIN]
    b = np.asarray(cpu_out)[:, BAND_MARGIN:-BAND_MARGIN]
    st = code_diff_stats(a, b)
    rep.line(
        "fidelity", test="effects_band_gpu_vs_cpu", band=f"{BAND_ROWS}x{W}",
        scale_px_per_mm=cfg.scale, rows_compared=a.shape[1], **st,
    )
    rep.check("fidelity", "band_max_code", st["max_code"], BAND_CODE_MAX, "<=")
    rep.check("fidelity", "band_within1_share", st["within1"], BAND_WITHIN1_MIN, ">=")


def phase_four_cards(rep: Report, ctx: dict) -> None:
    import jax

    from raw2film_tpu.parallel.mesh import make_mesh, space_halo_rows
    from raw2film_tpu.pipeline.processor import Processor

    n = len(jax.devices())
    rep.require("four_cards", "device_count", n >= 4, f"{n} devices")
    if n < 4:
        return
    files = ctx["frames"][:4]
    proc = Processor()
    kw = dict(print_film=PRT, half_size=False, max_scale=None, **EFFECTS)

    t0 = time.perf_counter()
    sharded = proc.process_batch(files, NEG, mesh=make_mesh(4), **kw)
    t_sharded = time.perf_counter() - t0
    t0 = time.perf_counter()
    single = proc.process_batch(files, NEG, mesh=None, fused_decode=False, **kw)
    t_single = time.perf_counter() - t0
    worst = 0
    for i, (a, b) in enumerate(zip(sharded, single)):
        st = code_diff_stats(a, b)
        worst = max(worst, st["max_code"])
        rep.line("four_cards", test="batch_sharded_vs_single_card", frame=i, shape=a.shape, **st)
    rep.line(
        "four_cards", batch_wall_s=t_sharded, single_card_wall_s=t_single,
        note="wall includes host decode and compile",
    )
    rep.check("four_cards", "batch_max_code", worst, SHARD_CODE_MAX, "<=")

    mesh = make_mesh(4, batch=1, space=4)
    t0 = time.perf_counter()
    space = proc.process_batch(files[:1], NEG, mesh=mesh, **kw)[0]
    t_space = time.perf_counter() - t0
    d = np.abs(space.astype(np.int32) - single[0].astype(np.int32))
    interior = d[SEAM_MARGIN:-SEAM_MARGIN]
    h_loc = H // 4
    seams = [int(d[k * h_loc - 8 : k * h_loc + 8].max()) for k in (1, 2, 3)]
    from __graft_entry__ import _build

    halo = space_halo_rows(_build(H, W)[1], H, W)
    rep.line(
        "four_cards", test="space4_halo_vs_unsharded", halo_rows=halo, shard_rows=h_loc,
        interior_max_code=int(interior.max()), seam_max_codes=seams,
        frame_edge_max_code=int(d.max()), wall_s=t_space,
    )
    rep.check("four_cards", "space_interior_max_code", int(interior.max()), SHARD_CODE_MAX, "<=")


PHASE_FNS = {
    "full_res": phase_full_res,
    "export": phase_export,
    "preview": phase_preview,
    "fidelity": phase_fidelity,
    "four_cards": phase_four_cards,
}


def main(argv=None) -> int:
    args = parse_args(argv)
    phases = select_phases(args.four_cards)
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    try:
        from benchmarks import harness
    except ImportError as e:
        print(f"chip_smoke: the repository is not importable here ({e})", file=sys.stderr)
        return 2
    try:
        devices = harness.init_gpu_backend(with_cpu="fidelity" in phases)
    except harness.NoGpuError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    rep = Report(harness.card_line())
    device = harness.device_summary(devices)
    rep.line("device", **device, jax=__import__("jax").__version__)

    ctx = {"compile_clock": _CompileClock()}
    ctx["workdir"] = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t0 = time.perf_counter()
        n_frames = 4 if args.four_cards else EXPORT_FILES
        ctx["frames"] = write_frames(os.path.join(ctx["workdir"], "raw"), n_frames, H, W)
        rep.line("setup", dngs=n_frames, frame=f"{H}x{W}", seconds=time.perf_counter() - t0)
        for phase in phases:
            t0 = time.perf_counter()
            try:
                PHASE_FNS[phase](rep, ctx)
            except Exception as e:  # report every phase, then fail the run
                traceback.print_exc()
                rep.failures.append(f"{phase}: {type(e).__name__}: {e}")
            rep.line(phase, phase_seconds=time.perf_counter() - t0)
    finally:
        shutil.rmtree(ctx["workdir"], ignore_errors=True)
    if rep.failures:
        for f in rep.failures:
            print(f"FAILED {f}", file=sys.stderr)
        return 1
    print(result_line(device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
