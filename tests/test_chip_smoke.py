"""chip_smoke.py and benchmarks/harness.py: the parts that need no GPU, plus
the persistent compile-cache location (raw2film_tpu/config.py)."""

import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from benchmarks import harness  # noqa: E402


def _dev(platform, kind="NVIDIA H100 80GB HBM3"):
    return SimpleNamespace(platform=platform, device_kind=kind)


# ------------------------------------------------------------ harness


def test_require_gpu_accepts_gpu():
    harness.require_gpu([_dev("gpu")])


@pytest.mark.parametrize("devices", [[_dev("cpu", "cpu")], [_dev("rocm", "x")], []])
def test_require_gpu_refuses_other_platforms(devices):
    with pytest.raises(harness.NoGpuError):
        harness.require_gpu(devices)


def test_device_summary_keys():
    d = harness.device_summary([_dev("gpu")] * 4)
    assert d == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}


def test_time_ms_blocks_on_every_call():
    calls = []

    def fn(x):
        calls.append(x)
        return np.zeros(3)

    t = harness.time_ms(fn, 1, iters=4, warmup=2)
    assert len(calls) == 6
    assert len(t["ms"]) == 4
    assert t["min_ms"] <= t["median_ms"] <= t["max_ms"]


def test_on_platform_checks_every_shard():
    arr = SimpleNamespace(devices=lambda: [_dev("gpu"), _dev("gpu")])
    assert harness.on_platform(arr)
    mixed = SimpleNamespace(devices=lambda: [_dev("gpu"), _dev("cpu", "cpu")])
    assert not harness.on_platform(mixed)


# ------------------------------------------------------------ chip_smoke


def test_default_phases():
    assert chip_smoke.select_phases(False) == ("full_res", "export", "preview", "fidelity")


def test_four_card_option_runs_only_its_phase():
    assert chip_smoke.select_phases(True) == ("four_cards",)
    assert chip_smoke.parse_args(["--four-cards"]).four_cards
    assert not chip_smoke.parse_args([]).four_cards


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_format(count):
    line = chip_smoke.result_line(
        {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count}
    )
    assert "\n" not in line
    doc = json.loads(line)
    assert doc == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count},
    }


@pytest.mark.parametrize(
    "value,limit,op,ok",
    [
        (0.49, 0.5, "<", True),
        (0.5, 0.5, "<", False),
        (2, 2, "<=", True),
        (3, 2, "<=", False),
        (0.999, 0.999, ">=", True),
        (0.9989, 0.999, ">=", False),
    ],
)
def test_passes(value, limit, op, ok):
    assert chip_smoke.passes(value, limit, op) is ok


def test_passes_rejects_unknown_op():
    with pytest.raises(ValueError):
        chip_smoke.passes(1, 1, "==")


def test_code_diff_stats():
    a = np.full((3, 10, 10), 100, np.uint8)
    b = a.copy()
    assert chip_smoke.code_diff_stats(a, b) == {"max_code": 0, "within1": 1.0}
    b[0, 0, :5] = 101  # within one code
    b[1, 0, 0] = 103  # three codes (one value of 300)
    st = chip_smoke.code_diff_stats(a, b)
    assert st["max_code"] == 3
    assert st["within1"] == pytest.approx(299 / 300)


def test_report_lines_carry_card_and_record_failures(capsys):
    rep = chip_smoke.Report("NVIDIA H100 80GB HBM3, 700.00 W")
    assert rep.check("fidelity", "band_max_code", 1, 2, "<=")
    assert not rep.check("fidelity", "bare_de2000_max", 0.7, 0.5, "<")
    rep.require("full_res", "output_on_gpu", False, "cpu")
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 3
    assert all(line.endswith("| card: NVIDIA H100 80GB HBM3, 700.00 W") for line in out)
    assert "value=0.7 limit=< 0.5 result=FAIL" in out[1]
    assert rep.failures == [
        "fidelity.bare_de2000_max: 0.7 not < 0.5",
        "full_res.output_on_gpu: cpu",
    ]


@pytest.fixture
def fake_gpu(monkeypatch, tmp_path):
    """chip_smoke.main with a fake GPU, a fake nvidia-smi and stub phases."""
    ran = []
    devices = [_dev("gpu")]
    monkeypatch.setattr(harness, "init_gpu_backend", lambda with_cpu=False: devices)
    monkeypatch.setattr(harness, "card_line", lambda: "FakeCard, 700.00 W")
    monkeypatch.setattr(chip_smoke, "write_frames", lambda d, n, h, w: [f"f{i}" for i in range(n)])
    monkeypatch.setattr(chip_smoke, "_CompileClock", lambda: None)
    stubs = {name: (lambda rep, ctx, name=name: ran.append(name)) for name in chip_smoke.PHASE_FNS}
    monkeypatch.setattr(chip_smoke, "PHASE_FNS", stubs)
    return SimpleNamespace(ran=ran, devices=devices, stubs=stubs)


def test_main_runs_default_phases_and_ends_with_result(fake_gpu, capsys):
    assert chip_smoke.main([]) == 0
    assert fake_gpu.ran == ["full_res", "export", "preview", "fidelity"]
    lines = capsys.readouterr().out.splitlines()
    assert all("card: FakeCard, 700.00 W" in ln for ln in lines[:-1])
    assert json.loads(lines[-1])["device"]["count"] == 1


def test_main_four_cards_runs_only_sharded_phase(fake_gpu, capsys):
    fake_gpu.devices[:] = [_dev("gpu")] * 4
    assert chip_smoke.main(["--four-cards"]) == 0
    assert fake_gpu.ran == ["four_cards"]
    last = capsys.readouterr().out.splitlines()[-1]
    assert json.loads(last)["device"]["count"] == 4


def test_main_fails_without_result_when_a_phase_fails(fake_gpu, monkeypatch, capsys):
    def boom(rep, ctx):
        raise RuntimeError("out of memory")

    monkeypatch.setitem(fake_gpu.stubs, "export", boom)
    assert chip_smoke.main([]) == 1
    assert fake_gpu.ran == ["full_res", "preview", "fidelity"]  # later phases still run
    captured = capsys.readouterr()
    assert '"ok"' not in captured.out
    assert "FAILED export: RuntimeError: out of memory" in captured.err


def test_main_refuses_cpu(monkeypatch, capsys):
    def no_gpu(with_cpu=False):
        raise harness.NoGpuError("default JAX device is 'cpu'")

    monkeypatch.setattr(harness, "init_gpu_backend", no_gpu)
    assert chip_smoke.main([]) == 2
    assert '"ok"' not in capsys.readouterr().out


def test_script_fails_on_cpu_backend():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_script_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300,
    )
    assert r.returncode != 0
    assert r.stdout == ""


# ------------------------------------------------------------ compile cache


class _Recorder:
    def __init__(self):
        self.updates = {}

    def update(self, name, value):
        self.updates[name] = value


def test_cache_env_set_sets_nothing(monkeypatch, tmp_path):
    import jax

    from raw2film_tpu import config

    rec = _Recorder()
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "elsewhere"))
    monkeypatch.setattr(jax, "config", rec)
    assert config.jit_cache_dir() is None
    config.enable_persistent_jit_cache()
    assert rec.updates == {}


def test_cache_env_unset_uses_fixed_path_in_checkout(monkeypatch):
    import jax

    from raw2film_tpu import config

    rec = _Recorder()
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax, "config", rec)
    assert config.jit_cache_dir() == os.path.join(REPO, ".jax_cache")
    config.enable_persistent_jit_cache()
    assert rec.updates["jax_compilation_cache_dir"] == os.path.join(REPO, ".jax_cache")


def test_cache_dir_is_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        entries = {ln.strip() for ln in f}
    assert ".jax_cache/" in entries
    assert "raw2film_tpu/native/libr2f_native.so" in entries
