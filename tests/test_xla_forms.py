"""The chain's XLA formulations against independent numpy/scipy references.

These are the only device forms of each stage (convolution, resampling,
half-size decode, MHC demosaic, print tail, grain hash, halation mixture),
so each is pinned here against a reference that does not share its code.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import ndimage

from raw2film_tpu.ops import conv as convops

RNG = np.random.default_rng(7)


def _img(c, h, w, loc=0.3, scale=0.2):
    return RNG.normal(loc, scale, (c, h, w)).astype(np.float32)


def _correlate_mirror(x, k2d):
    """scipy 2D correlation with REFLECT_101 borders ('mirror'), per plane."""
    return np.stack([ndimage.correlate(p, k2d, mode="mirror") for p in x])


# ----------------------------------------------------------- convolution


class TestSeparableConv:
    @pytest.mark.parametrize("hw", [(600, 320), (137, 260), (64, 96)])
    def test_separable_conv_matches_scipy(self, hw):
        img = _img(3, *hw)
        kv = convops.gaussian_kernel1d(2.0)
        kh = convops.gaussian_kernel1d(1.4)
        got = np.asarray(convops.separable_conv(jnp.asarray(img), kv, kh))
        want = _correlate_mirror(img.astype(np.float64), np.outer(kv, kh))
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_column_pass_matches_scipy(self):
        img = _img(3, 600, 256)
        k = convops.gaussian_kernel1d(3.0)  # 25 taps
        got = np.asarray(convops._conv1d_axis(jnp.asarray(img), k, -2))
        want = ndimage.correlate1d(img.astype(np.float64), k, axis=-2, mode="mirror")
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_rank_sum(self):
        img = _img(3, 300, 200)
        u = np.stack(
            [convops.gaussian_kernel1d(1.0, truncate=8.0), 0.3 * convops.gaussian_kernel1d(2.0)]
        )
        v = np.stack(
            [convops.gaussian_kernel1d(1.0, truncate=8.0), convops.gaussian_kernel1d(2.0)]
        )
        got = np.asarray(convops.conv2d_svd(jnp.asarray(img), u, v))
        want = _correlate_mirror(img.astype(np.float64), u.T.astype(np.float64) @ v)
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_per_channel_ranks(self):
        img = _img(3, 96, 160)
        u = RNG.random((3, 2, 9)).astype(np.float32) * 0.3
        v = RNG.random((3, 2, 9)).astype(np.float32) * 0.3
        got = np.asarray(convops.conv2d_svd(jnp.asarray(img), u, v))
        for c in range(3):
            k2 = u[c].T.astype(np.float64) @ v[c].astype(np.float64)
            want = ndimage.correlate(img[c].astype(np.float64), k2, mode="mirror")
            np.testing.assert_allclose(got[c], want, atol=2e-5)

    def test_dense_depthwise_matches_scipy(self):
        img = _img(3, 70, 90)
        k = RNG.normal(0.0, 0.1, (11, 11)).astype(np.float32)
        got = np.asarray(convops.depthwise_conv2d(jnp.asarray(img), k))
        want = _correlate_mirror(img.astype(np.float64), k.astype(np.float64))
        np.testing.assert_allclose(got, want, atol=2e-5)


# ----------------------------------------------------------- resampling


def _block_mean(x, f):
    c, h, w = x.shape
    h2, w2 = h // f, w // f
    return x[:, : h2 * f, : w2 * f].reshape(c, h2, f, w2, f).mean(axis=(2, 4))


def _bilinear_np(x, oh, ow):
    """Half-pixel-centre bilinear resize with edge clamp (float64)."""

    def weights(n_in, n_out):
        m = np.zeros((n_out, n_in))
        scale = n_in / n_out
        for o in range(n_out):
            rel = (o + 0.5) * scale - 0.5
            rel = min(max(rel, 0.0), n_in - 1.0)
            i0 = int(np.floor(rel))
            i1 = min(i0 + 1, n_in - 1)
            m[o, i0] += 1.0 - (rel - i0)
            m[o, i1] += rel - i0
        return m

    mh = weights(x.shape[-2], oh)
    mw = weights(x.shape[-1], ow)
    return np.einsum("Oh,chw,Ww->cOW", mh, x.astype(np.float64), mw)


class TestBoxDownsample:
    @pytest.mark.parametrize("f", [2, 4, 8])
    @pytest.mark.parametrize("hw", [(96, 1280), (70, 1333)])
    def test_matches_block_mean(self, f, hw):
        img = _img(3, *hw)
        got = np.asarray(convops.box_downsample(jnp.asarray(img), f))
        want = _block_mean(img.astype(np.float64), f)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_small_image(self):
        img = _img(3, 12, 40)
        got = np.asarray(convops.box_downsample(jnp.asarray(img), 4))
        np.testing.assert_allclose(got, _block_mean(img.astype(np.float64), 4), atol=1e-6)

    @pytest.mark.parametrize("f", [55, 110])
    def test_large_factor(self, f):
        """The burn glow downsamples by f ~ min(H,W)/50 (>100 at 45 MP)."""
        img = _img(1, 9 * f + 13, 15 * f + 7)
        got = np.asarray(convops.box_downsample(jnp.asarray(img), f))
        want = _block_mean(img.astype(np.float64), f)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5)


class TestBilinearUpsample:
    @pytest.mark.parametrize("f", [2, 4])
    def test_matches_numpy(self, f):
        img = _img(3, 48, 400)
        got = np.asarray(convops.bilinear_upsample(jnp.asarray(img), (48 * f, 400 * f)))
        np.testing.assert_allclose(got, _bilinear_np(img, 48 * f, 400 * f), atol=2e-5)

    def test_zoom_upsample_edge_pads_to_frame(self):
        img = _img(1, 40, 400)
        got = np.asarray(convops.zoom_upsample(jnp.asarray(img), 4, (163, 1603)))
        want = np.pad(_bilinear_np(img, 160, 1600), [(0, 0), (0, 3), (0, 3)], mode="edge")
        assert got.shape == (1, 163, 1603)
        np.testing.assert_allclose(got, want, atol=2e-5)

    def test_small_image(self):
        img = _img(3, 10, 30)
        got = np.asarray(convops.bilinear_upsample(jnp.asarray(img), (40, 120)))
        np.testing.assert_allclose(got, _bilinear_np(img, 40, 120), atol=2e-5)

    @pytest.mark.parametrize("f", [55, 110])
    def test_large_factor(self, f):
        img = _img(1, 11, 31)
        got = np.asarray(convops.bilinear_upsample(jnp.asarray(img), (11 * f, 31 * f)))
        np.testing.assert_allclose(got, _bilinear_np(img, 11 * f, 31 * f), atol=2e-5)


def _down_up_np(mask, f):
    """Reference highlight-burn glow: block mean, sigma-3 truncate-2
    Gaussian (REFLECT_101), bilinear upsample, edge pad — float64."""
    small = _block_mean(mask.astype(np.float64), f)
    k = convops.gaussian_kernel1d(3.0, truncate=2.0).astype(np.float64)
    blurred = ndimage.correlate1d(small, k, axis=-2, mode="mirror")
    blurred = ndimage.correlate1d(blurred, k, axis=-1, mode="mirror")
    hs, ws = small.shape[-2:]
    up = _bilinear_np(blurred, hs * f, ws * f)
    h, w = mask.shape[-2:]
    return np.pad(up, [(0, 0), (0, h - hs * f), (0, w - ws * f)], mode="edge")


class TestBurnGlow:
    @pytest.mark.parametrize("f", [24, 56, 110])
    def test_down_up_blur_matches_numpy(self, f):
        from raw2film_tpu.ops import burn as burn_ops

        mask = np.maximum(RNG.normal(0.1, 0.4, (1, 9 * f + 13, 15 * f + 7)), 0)
        mask = mask.astype(np.float32)
        got = np.asarray(burn_ops.down_up_blur(jnp.asarray(mask), factor=f))
        assert got.shape == mask.shape
        np.testing.assert_allclose(got, _down_up_np(mask, f), atol=1e-5)

    def test_burn_subtracts_scaled_glow(self):
        from raw2film_tpu.ops import burn as burn_ops

        d = RNG.uniform(0.2, 3.0, (3, 120, 180)).astype(np.float32)
        got = np.asarray(burn_ops.burn(jnp.asarray(d), 1.2, 0.6, burn_scale=10.0))
        f = 12  # ceil(120 / 10)
        glow = _down_up_np(np.maximum(d[1:2] - 1.2, 0.0), f)
        np.testing.assert_allclose(got, np.maximum(d - 0.6 * glow, 0.0), atol=2e-5)

    def test_row_offset_grid_is_global(self):
        """The row-sharded burn aligns its cells to global rows: a traced
        offset of a whole number of cells gives the same glow as offset 0,
        and an offset inside a cell gives a different one."""
        from raw2film_tpu.ops import burn as burn_ops

        d = jnp.asarray(RNG.uniform(0.2, 3.0, (3, 120, 180)).astype(np.float32))
        run = jax.jit(
            lambda off: burn_ops.burn(
                d, 1.2, 0.6, burn_scale=10.0, ref_hw=(120, 180), row_offset=off
            )
        )
        base = np.asarray(run(jnp.int32(0)))
        np.testing.assert_array_equal(np.asarray(run(jnp.int32(24))), base)
        assert not np.array_equal(np.asarray(run(jnp.int32(5))), base)


# ----------------------------------------------------------- halation


class TestHalationMixture:
    def test_mixture_tier_close_to_exact(self):
        """Kernel size 55 px: the Gaussian-mixture tier with /4 pyramid
        terms stays within the fit-residual gate of the exact kernel."""
        from raw2film_tpu.ops import halation as hal_ops

        img = jnp.asarray((RNG.random((3, 200, 1408)) * 2).astype(np.float32))
        scale = 220.0
        fast = np.asarray(hal_ops.halation(img, scale=scale))
        exact = np.asarray(hal_ops.halation(img, scale=scale, exact=True))
        assert np.abs(fast - exact).max() < 0.02
        assert np.abs(fast - exact).mean() < 0.004

    def test_svd_tier_close_to_exact(self):
        """Kernel size 12-40 px: the SVD-separable tier."""
        from raw2film_tpu.ops import halation as hal_ops

        img = jnp.asarray((RNG.random((3, 120, 200)) * 2).astype(np.float32))
        scale = 100.0  # kernel size 25 px
        fast = np.asarray(hal_ops.halation(img, scale=scale))
        exact = np.asarray(hal_ops.halation(img, scale=scale, exact=True))
        assert np.abs(fast - exact).max() < 5e-3


# ----------------------------------------------------------- demosaic

_PATTERN_OFFSETS = {"RGGB": (0, 0), "BGGR": (1, 1), "GRBG": (0, 1)}


def _mhc_numpy(bayer, pattern):
    """Malvar-He-Cutler (ICASSP 2004) with scipy correlations, float64."""
    g_at_rb = np.array(
        [[0, 0, -1, 0, 0], [0, 0, 2, 0, 0], [-1, 2, 4, 2, -1], [0, 0, 2, 0, 0], [0, 0, -1, 0, 0]]
    ) / 8.0
    rb_row = np.array(
        [[0, 0, 0.5, 0, 0], [0, -1, 0, -1, 0], [-1, 4, 5, 4, -1], [0, -1, 0, -1, 0], [0, 0, 0.5, 0, 0]]
    ) / 8.0
    rb_col = rb_row.T
    rb_opp = np.array(
        [[0, 0, -1.5, 0, 0], [0, 2, 0, 2, 0], [-1.5, 0, 6, 0, -1.5], [0, 2, 0, 2, 0], [0, 0, -1.5, 0, 0]]
    ) / 8.0
    x = bayer.astype(np.float64)
    c = {k: ndimage.correlate(x, v, mode="mirror") for k, v in
         (("g", g_at_rb), ("row", rb_row), ("col", rb_col), ("opp", rb_opp))}
    ry, rx = _PATTERN_OFFSETS[pattern]
    yy, xx = np.mgrid[0 : x.shape[0], 0 : x.shape[1]]
    yy, xx = yy & 1, xx & 1
    r_site = (yy == ry) & (xx == rx)
    b_site = (yy == 1 - ry) & (xx == 1 - rx)
    g_rrow = (yy == ry) & (xx == 1 - rx)
    g_brow = (yy == 1 - ry) & (xx == rx)
    g = np.where(r_site | b_site, c["g"], x)
    r = np.select([r_site, g_rrow, g_brow], [x, c["row"], c["col"]], c["opp"])
    b = np.select([b_site, g_brow, g_rrow], [x, c["row"], c["col"]], c["opp"])
    return np.stack([r, g, b])


class TestDemosaic:
    @pytest.mark.parametrize("pattern", ["RGGB", "BGGR", "GRBG"])
    def test_mhc_matches_numpy(self, pattern):
        from raw2film_tpu.ops import demosaic as dm

        bayer = RNG.random((64, 96)).astype(np.float32)
        got = np.asarray(dm.demosaic_mhc(jnp.asarray(bayer), pattern))
        np.testing.assert_allclose(got, _mhc_numpy(bayer, pattern), atol=2e-6)

    @pytest.mark.parametrize("pattern", ["RGGB", "BGGR", "GRBG"])
    def test_exposure_matches_numpy(self, pattern):
        """demosaic_exposure = max(mat @ clip01(MHC), 0)."""
        from raw2film_tpu.ops import demosaic as dm

        bayer = RNG.normal(0.4, 0.3, (64, 96)).astype(np.float32)
        mat = RNG.normal(0.3, 0.4, (3, 3)).astype(np.float32)
        got = np.asarray(dm.demosaic_exposure(jnp.asarray(bayer), pattern, mat))
        rgb = np.clip(_mhc_numpy(bayer, pattern), 0.0, 1.0)
        want = np.maximum(np.einsum("ij,jhw->ihw", mat.astype(np.float64), rgb), 0.0)
        np.testing.assert_allclose(got, want, atol=2e-6)


class TestHalfSizeDecode:
    @pytest.mark.parametrize("pattern", ["RGGB", "BGGR", "GRBG"])
    def test_matches_cell_average(self, pattern):
        from raw2film_tpu.ops.demosaic import half_size_decode

        bayer = RNG.random((96, 1280)).astype(np.float32)
        got = np.asarray(half_size_decode(jnp.asarray(bayer), pattern))
        cells = bayer.reshape(48, 2, 640, 2).transpose(1, 3, 0, 2)  # (dy, dx, h, w)
        ry, rx = _PATTERN_OFFSETS[pattern]
        want = np.stack(
            [
                cells[ry, rx],
                0.5 * (cells[ry, 1 - rx] + cells[1 - ry, rx]),
                cells[1 - ry, 1 - rx],
            ]
        )
        np.testing.assert_allclose(got, want, atol=1e-6)

    def test_odd_size_drops_partial_cell(self):
        from raw2film_tpu.ops.demosaic import half_size_decode

        bayer = jnp.asarray(RNG.random((21, 41)).astype(np.float32))
        assert half_size_decode(bayer, "RGGB").shape == (3, 10, 20)

    def test_unknown_pattern_raises(self):
        from raw2film_tpu.ops.demosaic import half_size_decode

        with pytest.raises(ValueError, match="pattern"):
            half_size_decode(jnp.zeros((8, 8), jnp.float32), "RGBW")


# ----------------------------------------------------------- print tail

TAIL_CASES = [
    dict(mode="print", shadow_comp=0.0, sat=1.0, gamma="sRGB"),
    dict(mode="print", shadow_comp=0.35, sat=1.3, gamma="Rec709"),
    dict(mode="inversion", shadow_comp=0.0, sat=1.3, gamma="Gamma 2.2"),
    dict(mode="direct", shadow_comp=0.35, sat=1.0, gamma="ARRI LogC3"),
    dict(mode="print", shadow_comp=0.0, sat=1.0, gamma="Linear"),
]


def _tail_setup(case):
    from raw2film_tpu.film import chain as fchain
    from raw2film_tpu.film.loader import load_film_stocks
    from raw2film_tpu.pipeline.render import RenderConfig, make_film_bundle

    stocks = load_film_stocks()
    if case["mode"] == "direct":
        neg, prt = stocks["Kodak Ektachrome E100"], None
    elif case["mode"] == "inversion":
        neg, prt = stocks["Kodak Portra 400"], None
    else:
        neg, prt = stocks["Kodak Portra 400"], stocks["Fuji Crystal Archive Maxima"]
    neg_p = fchain.build_negative_params(neg)
    prt_p = fchain.build_print_params(
        neg, prt, shadow_comp=case["shadow_comp"], neg_params=neg_p,
        inversion=case["mode"] == "inversion",
    )
    assert prt_p.mode == case["mode"]
    out_p = fchain.build_output_params(
        neg, prt, prt_p, neg_p, sat_adjust=case["sat"], gamma_func=case["gamma"]
    )
    bundle = make_film_bundle(neg_p, prt_p, out_p, sat=case["sat"])
    cfg = RenderConfig(
        scale=20.0, print_mode=prt_p.mode, shadow_comp=bool(case["shadow_comp"]),
        sat_neutral=case["sat"] == 1.0, gamma_func=case["gamma"],
    )
    return prt_p, out_p, bundle, cfg


@pytest.mark.parametrize("case", TAIL_CASES, ids=lambda c: f"{c['mode']}-{c['gamma']}")
@pytest.mark.parametrize("quantize", [True, False])
def test_print_tail_matches_oracle(case, quantize):
    """_print_tail (f32, base-2 transcendentals) against the float64 host
    oracle's print -> encode on the same density image."""
    import dataclasses

    from raw2film_tpu.film import chain as fchain
    from raw2film_tpu.pipeline.render import _print_tail

    prt_p, out_p, bundle, cfg = _tail_setup(case)
    cfg = dataclasses.replace(cfg, quantize=quantize)
    rng = np.random.default_rng(zlib.crc32(repr(sorted(case.items())).encode()))
    d = rng.uniform(0.1, 2.8, (3, 32, 48)).astype(np.float32)
    want = fchain.encode_output(fchain.print_to_linear_xyz(d.astype(np.float64), prt_p), out_p)
    got = np.asarray(_print_tail(jnp.asarray(d), bundle, cfg))
    if quantize:
        assert got.dtype == np.uint8
        ref = np.round(np.clip(want, 0.0, 1.0) * 255.0)
        assert np.abs(got.astype(np.int32) - ref).max() <= 1
    else:
        np.testing.assert_allclose(got, np.clip(want, 0.0, 1.0), atol=2e-4)


# ----------------------------------------------------------- grain hash


class TestGrainHash:
    def test_white_noise_statistics(self):
        from scipy import stats

        from raw2film_tpu.ops.grain import grain_field_hash, seed2

        f = np.asarray(grain_field_hash(seed2(7), (256, 256), 0.0))
        assert abs(float(f.mean())) < 0.02
        assert 0.97 < float(f.std()) < 1.03
        assert abs(float(stats.kurtosis(f.ravel()))) < 0.1

    def test_correlated_field_unit_variance(self):
        from raw2film_tpu.ops.grain import grain_field_hash, seed2

        f = np.asarray(grain_field_hash(seed2(3), (256, 256), 1.2))
        assert 0.9 < float(f.std()) < 1.1
        c = np.corrcoef(f[0, :, :-1].ravel(), f[0, :, 1:].ravel())[0, 1]
        assert c > 0.2

    def test_deterministic_and_seed_sensitive(self):
        from raw2film_tpu.ops.grain import grain_field_hash, seed2

        a = np.asarray(grain_field_hash(seed2(7), (64, 128), 0.9))
        b = np.asarray(grain_field_hash(seed2(7), (64, 128), 0.9))
        c = np.asarray(grain_field_hash(seed2(8), (64, 128), 0.9))
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, c)

    @pytest.mark.parametrize("offset", [1, 17, 40])
    def test_row_offset_selects_rows_of_one_field(self, offset):
        """A shard starting at global row ``offset`` sees exactly those rows
        of the whole frame's field (the space-sharding contract)."""
        from raw2film_tpu.ops.grain import grain_field_hash, seed2

        whole = np.asarray(grain_field_hash(seed2(1234, 0), (96, 80), 0.9))
        part = np.asarray(grain_field_hash(seed2(1234, offset), (32, 80), 0.9))
        np.testing.assert_allclose(part, whole[:, offset : offset + 32], atol=1e-6)

    def test_bw_shares_one_field(self):
        from raw2film_tpu.ops.grain import grain_field_hash, seed2

        f = np.asarray(grain_field_hash(seed2(5), (48, 64), 0.9, bw=True))
        np.testing.assert_array_equal(f[0], f[1])
        np.testing.assert_array_equal(f[1], f[2])

    def test_channels_independent(self):
        from raw2film_tpu.ops.grain import grain_field_hash, seed2

        f = np.asarray(grain_field_hash(seed2(5), (128, 128), 0.0))
        c = np.corrcoef(f[0].ravel(), f[1].ravel())[0, 1]
        assert abs(c) < 0.05

    def test_corr_taps_l2_normalized(self):
        from raw2film_tpu.ops.grain import grain_corr_taps

        assert grain_corr_taps(0.1) == (1.0,)
        taps = np.asarray(grain_corr_taps(1.3))
        assert len(taps) % 2 == 1
        np.testing.assert_allclose(np.sum(taps**2), 1.0, rtol=1e-12)

    def test_seed2_forms(self):
        from raw2film_tpu.ops.grain import seed2

        np.testing.assert_array_equal(np.asarray(seed2(9, 4)), [9, 4])
        np.testing.assert_array_equal(np.asarray(seed2(jnp.asarray([9]), -1)), [9, 2**32 - 1])
        pair = jnp.asarray([3, 5], jnp.uint32)
        np.testing.assert_array_equal(np.asarray(seed2(pair, 99)), [3, 5])

    def test_gauss_pair_moments(self):
        """popcount binomial: mean 0, variance exactly 1 over uniform words."""
        from raw2film_tpu.ops.grain import _gauss_pair

        r = np.random.default_rng(0)
        u = jnp.asarray(r.integers(0, 2**32, 200_000, dtype=np.uint64).astype(np.uint32))
        v = jnp.asarray(r.integers(0, 2**32, 200_000, dtype=np.uint64).astype(np.uint32))
        g = np.asarray(_gauss_pair(u, v))
        assert abs(g.mean()) < 0.01
        assert abs(g.var() - 1.0) < 0.01
        assert set(np.unique(g * 4 + 32).astype(int)) <= set(range(65))

    def test_grain_stage_is_amplitude_times_field(self):
        """render.grain_stage == max(d + amplitude(d) * field, 0) built from
        the public pieces (the field keyed like the render keys it)."""
        from raw2film_tpu.ops import grain as grain_ops
        from raw2film_tpu.pipeline.render import RenderConfig, grain_stage

        cfg = RenderConfig(scale=120.0, grain=2)
        bundle = {
            "grain_shape": jnp.asarray([1.0, 1.2, 0.15, 0.2, 2.9], jnp.float32),
            "grain_rms": jnp.float32(12.0),
        }
        d = jnp.asarray(RNG.uniform(0.3, 2.5, (3, 40, 64)).astype(np.float32))
        key = jax.random.PRNGKey(3)
        got = np.asarray(grain_stage(d, bundle, cfg, key))
        field = np.asarray(
            grain_ops.generate_grain_field(key, (40, 64), 120.0, cfg.grain_size_mm, cfg.grain_sigma)
        )
        amp = np.asarray(
            grain_ops.grain_amplitude_device(d, 12.0, 0.2, 2.9, 120.0, 1.0, 1.2, 0.15)
        )
        want = np.maximum(np.asarray(d) + amp * field, 0.0)
        np.testing.assert_allclose(got, want, atol=1e-5)
