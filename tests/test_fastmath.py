"""Unit pins for ops/fastmath.py: every base-2 helper against the straight
float64 form over wide ranges, including the piecewise boundaries the chain
actually crosses.

The helpers are exact algebraic rewrites (constant folds, not
approximations), so the only admissible error is f32 rounding: a few ulps.
The chain-level guarantee (<=1 u8 code) is pinned elsewhere
(goldens); these tests localize a regression to the
specific helper instead of a downstream diff.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
import pytest

from raw2film_tpu.ops import fastmath as fm
from raw2film_tpu.film import transfer


def _rel_err(got, want):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    scale = np.maximum(np.abs(want), 1e-12)
    return np.max(np.abs(got - want) / scale)


def test_pow10_matches_f64():
    # Chain exposures live in roughly [-8, 4] log10 units.
    x = np.linspace(-8.0, 4.0, 4001, dtype=np.float32)
    got = np.asarray(fm.pow10(jnp.asarray(x)))
    want = np.power(10.0, x.astype(np.float64))
    # f32 rounding of the exp2 argument t = x*log2(10) gives relative error
    # ~|t|*eps ~ 27*6e-8 at the range edge.
    assert _rel_err(got, want) < 5e-6


def test_log10_matches_f64():
    x = np.concatenate(
        [
            np.geomspace(1e-10, 1e4, 4001),
            [1.0, 10.0, 0.1],  # exact anchors
        ]
    ).astype(np.float32)
    got = np.asarray(fm.log10(jnp.asarray(x)))
    want = np.log10(x.astype(np.float64))
    assert np.max(np.abs(got - want)) < 3e-6


def test_expe_matches_f64():
    x = np.linspace(-30.0, 10.0, 4001, dtype=np.float32)
    got = np.asarray(fm.expe(jnp.asarray(x)))
    want = np.exp(x.astype(np.float64))
    assert _rel_err(got, want) < 5e-6


@pytest.mark.parametrize("w", [0.05, 0.35, 1.0, 3.0])
def test_softplus_matches_f64_and_is_overflow_safe(w):
    u = np.linspace(-80.0, 80.0, 8001, dtype=np.float32)
    got = np.asarray(fm.softplus(jnp.asarray(u), np.float32(w)))
    t = u.astype(np.float64) / w
    want = w * np.logaddexp(0.0, t)
    assert np.all(np.isfinite(got))
    # Absolute tolerance: softplus -> 0 in the deep negative tail where
    # relative error is meaningless. Bound: f32 ulp at the range edge
    # (|u|=80) is ~6e-6 and the rewrite adds a handful of roundings, so
    # 5e-5 is ~8 ulps of headroom — tight enough to catch any formula drift.
    assert np.max(np.abs(got - want)) < 5e-5
    # Large-argument limit: softplus(u, w) -> u exactly (the H&D shoulder).
    assert abs(float(fm.softplus(jnp.float32(75.0), np.float32(w))) - 75.0) < 1e-3


def test_powc_matches_f64_and_underflows_cleanly():
    x = np.geomspace(1e-12, 1.0, 2001).astype(np.float32)
    for p in (1.0 / 2.4, 0.45, 2.2):
        got = np.asarray(fm.powc(jnp.asarray(x), p))
        want = np.power(x.astype(np.float64), p)
        # |log2(1e-12)*2.2| ~ 88: argument rounding dominates.
        assert _rel_err(got, want) < 2e-5
    # x == 0 must not produce inf/nan (log2 clamp, then exp2 underflow).
    z = float(fm.powc(jnp.float32(0.0), 2.4))
    assert np.isfinite(z) and z < 1e-60


@pytest.mark.parametrize(
    "key", ["Linear", "sRGB", "Display P3", "Rec709", "Gamma 2.2",
            "Gamma 2.4", "ARRI LogC3"]
)
def test_encode_matches_transfer_reference(key):
    # Dense sweep plus the exact piecewise break points of each curve.
    x = np.concatenate(
        [
            np.linspace(0.0, 1.0, 4001),
            [0.0031308, 0.018, 0.010591, 0.0, 1.0],
        ]
    ).astype(np.float32)
    got = np.asarray(fm.encode(jnp.asarray(x), key))
    # True float64 oracle: pass the numpy array directly so transfer.encode
    # computes with xp=np at f64 (jnp.asarray would silently downcast to f32
    # since the suite never enables jax_enable_x64).
    want = np.asarray(transfer.encode(x.astype(np.float64), key))
    # Exclude samples within 1e-6 of the curve's piecewise breakpoint: the
    # rounded published constants make the two branches disagree by up to
    # 2.2e-4 AT the break (Rec709's 4.5*0.018 vs 1.099*0.018^0.45-0.099),
    # so f32-vs-f64 branch selection there measures the curve's own
    # discontinuity, not helper accuracy. Off-breakpoint the helpers track
    # the f64 oracle to <=2.5e-7 (measured) — 3e-6 keeps margin.
    bp = {
        "sRGB": 0.0031308,
        "Display P3": 0.0031308,
        "Rec709": 0.018,
        "ARRI LogC3": 0.010591,
    }.get(key)
    mask = (
        np.abs(x.astype(np.float64) - bp) > 1e-6
        if bp is not None
        else np.ones_like(x, bool)
    )
    assert np.max(np.abs(got - want)[mask]) < 3e-6
    # At the breakpoint itself the value must land between the two branch
    # limits (either side of the published-constant discontinuity).
    if bp is not None:
        at = float(fm.encode(jnp.float32(bp), key))
        lo = float(transfer.encode(np.float64(bp) - 1e-9, key))
        hi = float(transfer.encode(np.float64(bp) + 1e-9, key))
        lo, hi = min(lo, hi), max(lo, hi)
        assert lo - 3e-6 <= at <= hi + 3e-6
    # Monotone non-decreasing over the sweep (sorted part only).
    g = got[:4001]
    assert np.all(np.diff(g) >= -1e-6)


def test_encode_rejects_unknown_key():
    with pytest.raises(ValueError):
        fm.encode(jnp.zeros((4,), jnp.float32), "BT.2446")
