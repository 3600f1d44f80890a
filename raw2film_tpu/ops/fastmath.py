"""exp2/log2 formulations of the chain's transcendental ops.

`jnp.power` lowers to a general powf routine, while `exp2`/`log2` map to
the hardware's base-2 transcendental sequences. Each helper is
mathematically identical to the straight form (exact constant folds, not
approximations); f32 results differ only in final ulps (<=1 u8 code
through the chain). Whether the base-2 forms are faster on the GPU has
not been measured.

Used by the device chain (pipeline/render.py, ops/grain.py); the f64 host
oracle (film/chain.py) keeps the straight forms.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

LOG2_10 = np.float32(np.log2(10.0))  # exact double rounded once to f32
LOG10_2 = np.float32(np.log10(2.0))
LOG2_E = np.float32(np.log2(np.e))
LN_2 = np.float32(np.log(2.0))


def pow10(x):
    """10**x via the base-2 hardware path."""
    return jnp.exp2(x * LOG2_10)


def log10(x):
    """log10(x) via log2."""
    return jnp.log2(x) * LOG10_2


def expe(x):
    """e**x via exp2."""
    return jnp.exp2(x * LOG2_E)


def softplus(u, w):
    """w * log(1 + exp(u/w)), overflow-safe, in exp2/log2 form.

    max(t,0) + log1p(exp(-|t|)) with log1p(e) = ln2 * log2(1 + exp2(-|t|*log2e)).
    """
    t = u * (np.float32(1.0) / w)
    return w * (
        jnp.maximum(t, np.float32(0.0))
        + LN_2 * jnp.log2(np.float32(1.0) + jnp.exp2(-jnp.abs(t) * LOG2_E))
    )


def powc(x, p):
    """x**p for x > 0 (constant exponent) via exp2/log2; clamps x away from
    0 so log2 stays finite (exp2 of a large negative then underflows to 0,
    matching pow's limit)."""
    return jnp.exp2(jnp.log2(jnp.maximum(x, np.float32(1e-30))) * np.float32(p))


def encode(x, key: str):
    """film.transfer.encode with every pow/log in base-2 form (device jnp
    only; identical piecewise structure and constants — see
    film/transfer.py for the curve provenance)."""
    x = jnp.clip(x, 0.0, 1.0)
    if key == "Linear":
        return x
    if key in ("sRGB", "Display P3"):
        return jnp.where(
            x <= 0.0031308,
            np.float32(12.92) * x,
            np.float32(1.055) * powc(x, 1.0 / 2.4) - np.float32(0.055),
        )
    if key == "Rec709":
        return jnp.where(
            x < 0.018,
            np.float32(4.5) * x,
            np.float32(1.099) * powc(x, 0.45) - np.float32(0.099),
        )
    if key == "Gamma 2.2":
        return powc(x, 1.0 / 2.2)
    if key == "Gamma 2.4":
        return powc(x, 1.0 / 2.4)
    if key == "ARRI LogC3":
        cut, a, b, c, d, e, f = (
            0.010591, 5.555556, 0.052272, 0.247190, 0.385537, 5.367655, 0.092809,
        )
        return jnp.where(
            x > cut,
            np.float32(c) * LOG10_2 * jnp.log2(np.float32(a) * x + np.float32(b))
            + np.float32(d),
            np.float32(e) * x + np.float32(f),
        )
    raise ValueError(f"unknown gamma_func {key!r}")
