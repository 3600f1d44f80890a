"""Generic LUT application ops.

These exist for interop parity with the reference's LUT-centric engines —
applying user/third-party LUTs, ICC-baked output LUTs, and validating the
closed-form chain. Three families:

* :func:`apply_lut_2d` — energy-preserving chromaticity LUT, barycentric
  simplex interpolation (semantics of reference shaders/lut_2d.wgsl:39-101).
* :func:`apply_curve_1d` — per-channel tabulated curve ((4, N) layout),
  log-domain lookup (reference shaders/lut_1d.wgsl / multi_channel_interp).
* :func:`apply_lut_3d_tetrahedral` — classic 6-case tetrahedral interpolation
  (semantics of reference src/raw2film/utils.py:247-380).

The exact paths gather eight LUT entries per pixel and are meant for small
images / validation. For production-size application of *smooth* LUTs use
:func:`fit_lut3d_cp` + :func:`apply_lut_3d_cp`: a host-side CP (canonical
polyadic) factorization turns the 3D lookup into three 1D basis
interpolations + elementwise products over small tables.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


# --------------------------------------------------------------------- 2D


def apply_lut_2d(img: jnp.ndarray, lut: jnp.ndarray) -> jnp.ndarray:
    """img (3, H, W) XYZ; lut (N, N, 3) indexed [x_idx, y_idx].

    S = X+Y+Z; (x, y) = (X, Y) * (N-1)/S; two-triangle barycentric interp;
    result scaled by S. Black shortcut for S < 1e-12.
    """
    n = lut.shape[0]
    s = img[0] + img[1] + img[2]
    safe = s > 1e-12
    inv = jnp.where(safe, (n - 1.0) / jnp.maximum(s, 1e-12), 0.0)
    r = img[0] * inv
    g = img[1] * inv
    ri = jnp.clip(r.astype(jnp.int32), 0, n - 2)
    gi = jnp.clip(g.astype(jnp.int32), 0, n - 2)
    rf = r - ri
    gf = g - gi
    upper = (rf + gf) > 1.0

    flat = lut.reshape(-1, 3)

    def fetch(i, j):
        return jnp.take(flat, i * n + j, axis=0)  # (..., 3)

    r_val = fetch(ri + 1, gi)
    g_val = fetch(ri, gi + 1)
    s_lo = fetch(ri, gi)
    s_hi = fetch(ri + 1, gi + 1)

    rf_ = rf[..., None]
    gf_ = gf[..., None]
    lo = r_val * rf_ + g_val * gf_ + s_lo * (1.0 - rf_ - gf_)
    hi = r_val * (1.0 - gf_) + g_val * (1.0 - rf_) + s_hi * (rf_ + gf_ - 1.0)
    out = jnp.where(upper[..., None], hi, lo) * s[..., None]
    out = jnp.where(safe[..., None], out, 0.0)
    return jnp.moveaxis(out, -1, 0)


# --------------------------------------------------------------------- 1D


def resample_curve_uniform(curve: np.ndarray, n: int = 512):
    """Host: resample a (4, N) curve (row 0 = possibly non-uniform x-grid)
    onto a uniform grid. Returns (x_min, x_max, table (3, n))."""
    x = np.asarray(curve[0], np.float64)
    xu = np.linspace(x[0], x[-1], n)
    tab = np.stack([np.interp(xu, x, curve[1 + c]) for c in range(3)])
    return float(x[0]), float(x[-1]), tab.astype(np.float32)


def apply_curve_1d(
    img: jnp.ndarray, x_min: float, x_max: float, table: jnp.ndarray
) -> jnp.ndarray:
    """Per-channel uniform-grid linear interp: img (3, H, W) already in the
    curve's x-domain (log exposure); table (3, n)."""
    n = table.shape[1]
    pos = jnp.clip((img - x_min) / (x_max - x_min), 0.0, 1.0) * (n - 1)
    i0 = jnp.clip(pos.astype(jnp.int32), 0, n - 2)
    f = pos - i0
    outs = []
    for c in range(3):
        t = table[c]
        outs.append(jnp.take(t, i0[c]) * (1 - f[c]) + jnp.take(t, i0[c] + 1) * f[c])
    return jnp.stack(outs)


def apply_curve_1d_onehot(
    img: jnp.ndarray, x_min: float, x_max: float, table: jnp.ndarray
) -> jnp.ndarray:
    """Gather-free variant: linear interp as a one-hot matmul. Same
    semantics as :func:`apply_curve_1d` (HIGHEST precision: the table
    values must not be rounded to TF32)."""
    n = table.shape[1]
    pos = jnp.clip((img - x_min) / (x_max - x_min), 0.0, 1.0) * (n - 1)
    i0 = jnp.clip(jnp.floor(pos), 0, n - 2)
    f = pos - i0
    iota = jnp.arange(n, dtype=img.dtype)
    outs = []
    for c in range(3):
        p = i0[c].reshape(-1, 1)
        w = (
            (p == iota) * (1.0 - f[c].reshape(-1, 1))
            + ((p + 1) == iota) * f[c].reshape(-1, 1)
        ).astype(img.dtype)
        outs.append(
            jnp.matmul(w, table[c], precision=jax.lax.Precision.HIGHEST).reshape(
                img.shape[1:]
            )
        )
    return jnp.stack(outs)


# --------------------------------------------------------------------- 3D


def apply_lut_3d_tetrahedral(
    img: jnp.ndarray, lut: jnp.ndarray, scale: float = 0.25
) -> jnp.ndarray:
    """Exact 6-case tetrahedral interpolation.

    img (3, H, W) pre-scaled by ``scale`` into [0, 1] LUT coords; lut
    (N, N, N, 3) indexed [r, g, b]. Branch-free vectorized formulation of the
    reference's per-pixel cases (src/raw2film/utils.py:295-376).
    """
    n = lut.shape[0]
    coords = img * (scale * (n - 1))
    i0 = jnp.clip(coords.astype(jnp.int32), 0, n - 2)
    d = jnp.clip(coords - i0, 0.0, 1.0)
    # Upper-edge clamp: when coords lands beyond the last cell the reference
    # sets the fraction to exactly 1.
    d = jnp.where(coords >= (n - 1), 1.0, d)

    r0, g0, b0 = i0[0], i0[1], i0[2]
    dr, dg, db = d[0][..., None], d[1][..., None], d[2][..., None]

    flat = lut.reshape(-1, 3)

    def fetch(r, g, b):
        return jnp.take(flat, (r * n + g) * n + b, axis=0)

    c000 = fetch(r0, g0, b0)
    c100 = fetch(r0 + 1, g0, b0)
    c010 = fetch(r0, g0 + 1, b0)
    c001 = fetch(r0, g0, b0 + 1)
    c110 = fetch(r0 + 1, g0 + 1, b0)
    c101 = fetch(r0 + 1, g0, b0 + 1)
    c011 = fetch(r0, g0 + 1, b0 + 1)
    c111 = fetch(r0 + 1, g0 + 1, b0 + 1)

    # The 6 tetrahedra of the reference's case tree.
    t1 = c000 + dr * (c100 - c000) + dg * (c110 - c100) + db * (c111 - c110)
    t2 = c000 + dr * (c100 - c000) + db * (c101 - c100) + dg * (c111 - c101)
    t3 = c000 + db * (c001 - c000) + dr * (c101 - c001) + dg * (c111 - c101)
    t4 = c000 + db * (c001 - c000) + dg * (c011 - c001) + dr * (c111 - c011)
    t5 = c000 + dg * (c010 - c000) + db * (c011 - c010) + dr * (c111 - c011)
    t6 = c000 + dg * (c010 - c000) + dr * (c110 - c010) + db * (c111 - c110)

    rg = dr >= dg
    gb = dg >= db
    rb = dr >= db

    out = jnp.where(
        rg,
        jnp.where(gb, t1, jnp.where(rb, t2, t3)),
        jnp.where(~gb, t4, jnp.where(~rb, t5, t6)),
    )
    return jnp.moveaxis(out, -1, 0)


def fit_lut3d_cp(
    lut: np.ndarray, rank: int = 16, iters: int = 60, seed: int = 0
):
    """Host: CP/ALS factorization of a (N, N, N, 3) LUT.

    lut[r,g,b,c] ~= sum_k U[r,k] V[g,k] W[b,k] C[k,c].
    Returns (U, V, W, C, max_abs_err). Smooth film LUTs reach <1e-3 max error
    at rank ~16-24; callers should check the returned error against their
    fidelity budget (ΔE 0.5 ≈ 2e-3 in encoded RGB).
    """
    n = lut.shape[0]
    t = np.asarray(lut, np.float64).reshape(n, n, n * 3)  # fold c into last
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n, rank)) * 0.1 + 0.5
    v = rng.standard_normal((n, rank)) * 0.1 + 0.5
    w3 = rng.standard_normal((n * 3, rank)) * 0.1 + 0.5  # joint (b, c) mode

    full = np.asarray(lut, np.float64).reshape(n, n, n, 3)

    def unfold(a, mode):
        return np.moveaxis(a, mode, 0).reshape(a.shape[mode], -1)

    t3 = t.reshape(n, n, n * 3)
    for _ in range(iters):
        # mode-0
        kr = (v[:, None, :] * w3[None, :, :]).reshape(-1, rank)
        u = unfold(t3, 0) @ kr @ np.linalg.pinv(kr.T @ kr)
        # mode-1
        kr = (u[:, None, :] * w3[None, :, :]).reshape(-1, rank)
        v = unfold(t3, 1) @ kr @ np.linalg.pinv(kr.T @ kr)
        # mode-2 (joint b,c)
        kr = (u[:, None, :] * v[None, :, :]).reshape(-1, rank)
        w3 = unfold(t3, 2) @ kr @ np.linalg.pinv(kr.T @ kr)

    # Split the joint (b, c) mode into W (n, rank) x C (rank, 3) is not exact
    # in general; instead keep per-output-channel W_c: reshape to (n, 3, rank).
    w_bc = w3.reshape(n, 3, rank)
    approx = np.einsum("ir,jr,kcr->ijkc", u, v, w_bc)
    err = float(np.max(np.abs(approx - full)))
    return (
        u.astype(np.float32),
        v.astype(np.float32),
        w_bc.astype(np.float32),
        err,
    )


def _interp_factor(coords: jnp.ndarray, factor: jnp.ndarray) -> jnp.ndarray:
    """Linearly interpolate factor rows at fractional grid coords.

    coords (H, W) in [0, n-1]; factor (n, ...) -> (H, W, ...).
    Uses two gathers on an (n, rank) table — n*rank is tiny, and the gather
    count is O(rank) per pixel total across the contraction, far cheaper than
    8 full-LUT gathers.
    """
    n = factor.shape[0]
    i0 = jnp.clip(coords.astype(jnp.int32), 0, n - 2)
    f = (coords - i0)[..., None] if factor.ndim == 2 else (coords - i0)[..., None, None]
    a = jnp.take(factor, i0, axis=0)
    b = jnp.take(factor, i0 + 1, axis=0)
    return a * (1 - f) + b * f


def apply_lut_3d_cp(
    img: jnp.ndarray,
    u: jnp.ndarray,
    v: jnp.ndarray,
    w_bc: jnp.ndarray,
    scale: float = 0.25,
) -> jnp.ndarray:
    """Device: evaluate a CP-factored 3D LUT. img (3, H, W) -> (3, H, W).

    Three small-table interpolations + an elementwise rank contraction; no
    full-LUT gathers.
    """
    n = u.shape[0]
    coords = jnp.clip(img * scale, 0.0, 1.0) * (n - 1)
    fu = _interp_factor(coords[0], u)  # (H, W, r)
    fv = _interp_factor(coords[1], v)  # (H, W, r)
    fw = _interp_factor(coords[2], w_bc)  # (H, W, 3, r)
    prod = (fu * fv)[..., None, :] * fw  # (H, W, 3, r)
    out = prod.sum(-1)
    return jnp.moveaxis(out, -1, 0)
