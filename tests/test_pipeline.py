"""End-to-end pipeline tests: device chain vs host oracle, Processor API."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from raw2film_tpu.film import chain as fchain, spectra
from raw2film_tpu.film.loader import load_film_stocks
from raw2film_tpu.pipeline.params import ImageParams, ProfileParams, merge_params
from raw2film_tpu.pipeline.processor import Processor
from raw2film_tpu.pipeline.render import (
    build_render_config,
    make_film_bundle,
    render_jit,
)

STOCKS = load_film_stocks()
PORTRA = STOCKS["Kodak Portra 400"]
PAPER = STOCKS["Fuji Crystal Archive Maxima"]
RNG = np.random.default_rng(0)


def _scene(h=64, w=96):
    """Smooth synthetic scene in XYZ, planar."""
    yy, xx = np.mgrid[0:h, 0:w]
    from raw2film_tpu.data import REC709_TO_XYZ

    rgb = np.stack(
        [0.05 + 0.6 * xx / w, 0.05 + 0.5 * yy / h, 0.4 - 0.3 * xx / w]
    ).astype(np.float32)
    return np.einsum("ij,jhw->ihw", REC709_TO_XYZ, np.clip(rgb, 0, 1)).astype(
        np.float32
    )


def _delta_e_proxy(a_u8, b_u8):
    """Max per-channel 8-bit difference; 1 DN ~ 0.4 ΔE in midtones."""
    return np.abs(a_u8.astype(np.int32) - b_u8.astype(np.int32)).max()


def _merged(**over):
    base = merge_params(ProfileParams(), ImageParams())
    base.update(over)
    return base


class TestDeviceVsOracle:
    """Device chain (no spatial effects) must reproduce the host oracle to
    float precision — the ΔE<0.5 gate of BASELINE.json by construction."""

    @pytest.mark.parametrize(
        "neg_name,prt_name,inversion",
        [
            ("Kodak Portra 400", "Fuji Crystal Archive Maxima", False),
            ("Kodak Portra 400", None, True),
            ("Kodak Ektachrome E100", None, False),
            ("Kodak Tri-X 400", None, True),
            ("Kodak Vision3 500T", "Kodak 2383", False),
        ],
    )
    def test_bare_chain_matches_oracle(self, neg_name, prt_name, inversion):
        neg = STOCKS[neg_name]
        prt = STOCKS[prt_name] if prt_name else None
        xyz = _scene()

        neg_p = fchain.build_negative_params(neg)
        prt_p = fchain.build_print_params(neg, prt, inversion=inversion, neg_params=neg_p)
        out_p = fchain.build_output_params(neg, prt, prt_p, neg_p)

        want = fchain.render_oracle(xyz.astype(np.float64), neg_p, prt_p, out_p)
        want_u8 = np.round(np.clip(want, 0, 1) * 255).astype(np.uint8)

        merged = _merged(
            halation=False, sharpness=False, grain=0, highlight_burn=0.0
        )
        bundle = make_film_bundle(neg_p, prt_p, out_p)
        cfg = build_render_config(neg, prt, prt_p.mode, scale=64 / 36, merged=merged)
        got = np.asarray(
            render_jit(jnp.asarray(xyz), bundle, cfg, jax.random.PRNGKey(0))
        )
        # fp32 vs fp64 rounding can flip an 8-bit code at code boundaries.
        assert _delta_e_proxy(got, want_u8) <= 1, (neg_name, prt_name)

    def test_ciede2000_self_check(self):
        """Metric implementation vs Sharma et al. (2005) published pairs."""
        from oracle.color_metrics import ciede2000

        # (The near-180-degree hue-average pairs of the paper's table are
        # omitted: their published values hinge on the reference
        # spreadsheet's precision at the documented discontinuity.)
        pairs = [
            ((50.0, 2.6772, -79.7751), (50.0, 0.0, -82.7485), 2.0425),
            ((50.0, 3.1571, -77.2803), (50.0, 0.0, -82.7485), 2.8615),
            ((50.0, 2.5, 0.0), (73.0, 25.0, -18.0), 27.1492),
            ((50.0, 2.5, 0.0), (50.0, 0.0, -2.5), 4.3065),
        ]
        for l1, l2, want in pairs:
            got = float(ciede2000(np.asarray(l1), np.asarray(l2)))
            assert abs(got - want) < 5e-4, (l1, l2, got, want)

    @pytest.mark.parametrize(
        "neg_name,prt_name,inversion",
        [
            ("Kodak Portra 400", "Fuji Crystal Archive Maxima", False),
            ("Kodak Portra 400", None, True),
            ("Kodak Ektachrome E100", None, False),
            ("Kodak Tri-X 400", None, True),
            ("Kodak Vision3 500T", "Kodak 2383", False),
        ],
    )
    def test_measured_delta_e_2000(self, neg_name, prt_name, inversion):
        """The BASELINE.json fidelity gate as an actual number: CIEDE2000
        between device fp32 chain and float64 oracle < 0.5 everywhere."""
        from oracle.color_metrics import delta_e_2000_u8

        neg = STOCKS[neg_name]
        prt = STOCKS[prt_name] if prt_name else None
        xyz = _scene()
        neg_p = fchain.build_negative_params(neg)
        prt_p = fchain.build_print_params(
            neg, prt, inversion=inversion, neg_params=neg_p
        )
        out_p = fchain.build_output_params(neg, prt, prt_p, neg_p)
        want = fchain.render_oracle(xyz.astype(np.float64), neg_p, prt_p, out_p)
        want_u8 = np.round(np.clip(want, 0, 1) * 255).astype(np.uint8)
        merged = _merged(halation=False, sharpness=False, grain=0, highlight_burn=0.0)
        bundle = make_film_bundle(neg_p, prt_p, out_p)
        cfg = build_render_config(neg, prt, prt_p.mode, scale=64 / 36, merged=merged)
        got = np.asarray(
            render_jit(jnp.asarray(xyz), bundle, cfg, jax.random.PRNGKey(0))
        )
        de = delta_e_2000_u8(got, want_u8)
        # Quantized gate: dE2000 < 0.5 everywhere, EXCEPT pixels sitting on
        # an 8-bit rounding boundary (fp32 vs fp64 flips one code; that is
        # quantization, not color error). Those must be <=1 code per channel
        # and vanishingly rare.
        over = de >= 0.5
        if over.any():
            dn = np.abs(got.astype(np.int32) - want_u8.astype(np.int32))
            assert dn.max(axis=0)[over].max() <= 1, (neg_name, prt_name, de.max())
            assert over.mean() < 1e-3, (neg_name, prt_name, over.mean())
        assert np.percentile(de, 99.9) < 0.5, (neg_name, prt_name)

        # Float-domain gate (the BASELINE.json ΔE < 0.5 gate proper,
        # pre-quantization): strict MAX over every pixel, no boundary
        # carve-out — this is where the pipelines themselves are compared.
        from oracle.color_metrics import delta_e_2000_float

        cfg_f = dataclasses.replace(cfg, quantize=False)
        got_f = np.asarray(
            render_jit(jnp.asarray(xyz), bundle, cfg_f, jax.random.PRNGKey(0))
        )
        de_f = delta_e_2000_float(got_f, np.clip(want, 0.0, 1.0))
        assert de_f.max() < 0.5, (neg_name, prt_name, float(de_f.max()))

    def test_effects_change_output_but_stay_bounded(self):
        xyz = _scene(96, 144)
        neg_p = fchain.build_negative_params(PORTRA)
        prt_p = fchain.build_print_params(PORTRA, PAPER, neg_params=neg_p)
        out_p = fchain.build_output_params(PORTRA, PAPER, prt_p, neg_p)
        bundle = make_film_bundle(
            neg_p,
            prt_p,
            out_p,
            halation_intensity=1.0,
            halation_green_factor=0.3,
            grain_rms=PORTRA.grain.rms,
            grain_shape=(1.0, 1.2, 0.15, 0.2, 2.9),
            highlight_burn=0.3,
            d_ref_green=float(PORTRA.d_ref[1]),
        )
        merged_off = _merged(halation=False, sharpness=False, grain=0)
        merged_on = _merged(highlight_burn=0.3)
        cfg_off = build_render_config(PORTRA, PAPER, "print", 96 / 24, merged_off)
        cfg_on = build_render_config(PORTRA, PAPER, "print", 96 / 24, merged_on)
        key = jax.random.PRNGKey(0)
        off = np.asarray(render_jit(jnp.asarray(xyz), bundle, cfg_off, key))
        on = np.asarray(render_jit(jnp.asarray(xyz), bundle, cfg_on, key))
        diff = np.abs(off.astype(int) - on.astype(int))
        assert diff.mean() > 0.1  # effects visibly act
        assert diff.mean() < 40  # but don't destroy the image

    def test_icc_baked_pre_quantization(self):
        """ICC applies as a CP-factored LUT in float BEFORE the 8-bit
        rounding (reference property cpu_processor.py:255-263) — no double
        quantization on a fine gradient."""
        proc = Processor()
        # Smooth horizontal gradient scene.
        w = 512
        ramp = np.linspace(0.02, 0.9, w, dtype=np.float32)
        xyz = np.broadcast_to(ramp, (3, 16, w)).copy()
        kw = dict(print_film=None, grain=0, halation=False, sharpness=False,
                  half_size=False, max_scale=None)

        t = lambda x: np.clip(x, 0, 1) ** 1.35  # float-level transform
        off = proc.process(xyz, "Kodak Portra 400", **kw)
        on = proc.process(xyz, "Kodak Portra 400", icc_transform=t, **kw)
        ident = proc.process(
            xyz, "Kodak Portra 400", icc_transform=lambda x: x, **kw
        )

        # Identity transform through the bake changes nothing beyond CP fit
        # noise (<1 code value).
        assert np.abs(ident.astype(int) - off.astype(int)).max() <= 1
        # Float-reference: transform the unquantized encoded output.
        want = np.round(t(off.astype(np.float64) / 255.0) * 255.0)
        got = on.astype(np.float64)
        assert np.abs(got - want).max() <= 1.0
        # The old uint8 post-apply loses codes on a gradient; the baked path
        # must preserve at least as many distinct output levels.
        double_q = np.round(t(np.round(off[..., 0] / 255.0 * 255) / 255.0) * 255)
        assert len(np.unique(on[..., 0])) >= len(np.unique(double_q.astype(np.uint8)))

    def test_grain_deterministic_per_seed(self):
        xyz = _scene()
        neg_p = fchain.build_negative_params(PORTRA)
        prt_p = fchain.build_print_params(PORTRA, PAPER, neg_params=neg_p)
        out_p = fchain.build_output_params(PORTRA, PAPER, prt_p, neg_p)
        bundle = make_film_bundle(
            neg_p, prt_p, out_p, grain_rms=4.3, grain_shape=(1.0, 1.2, 0.15, 0.2, 2.9)
        )
        merged = _merged(halation=False, sharpness=False)
        cfg = build_render_config(PORTRA, PAPER, "print", 200.0, merged)
        a = np.asarray(render_jit(jnp.asarray(xyz), bundle, cfg, jax.random.PRNGKey(1)))
        b = np.asarray(render_jit(jnp.asarray(xyz), bundle, cfg, jax.random.PRNGKey(1)))
        c = np.asarray(render_jit(jnp.asarray(xyz), bundle, cfg, jax.random.PRNGKey(2)))
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, c)


class TestProcessor:
    @pytest.fixture(scope="class")
    def dng(self, tmp_path_factory):
        from raw2film_tpu.data import REC709_TO_XYZ, XYZ_TO_REC709
        from raw2film_tpu.io.dng import write_dng

        h, w = 96, 144
        yy, xx = np.mgrid[0:h, 0:w]
        rgb = np.stack([0.1 + 0.5 * xx / w, 0.1 + 0.4 * yy / h, 0.35 - 0.2 * xx / w], -1)
        cam = (rgb @ REC709_TO_XYZ.T) @ XYZ_TO_REC709.T
        mosaic = np.zeros((h, w))
        mosaic[0::2, 0::2] = cam[0::2, 0::2, 0]
        mosaic[0::2, 1::2] = cam[0::2, 1::2, 1]
        mosaic[1::2, 0::2] = cam[1::2, 0::2, 1]
        mosaic[1::2, 1::2] = cam[1::2, 1::2, 2]
        p = tmp_path_factory.mktemp("raw") / "test.dng"
        write_dng(str(p), np.clip(mosaic, 0, 1) * 60000, white_level=60000)
        return str(p)

    def test_process_smoke_config(self, dng):
        proc = Processor()
        out = proc.process(
            dng, PORTRA, print_film=PAPER, half_size=False, grain=0
        )
        assert out.dtype == np.uint8 and out.shape[-1] == 3
        assert 20 < out.mean() < 230

    def test_process_accepts_stock_names(self, dng):
        proc = Processor()
        out = proc.process(dng, "Kodak Portra 400", print_film="Kodak 2383")
        assert out.dtype == np.uint8

    def test_mtf_fidelity_flag_changes_sharpness_only(self, dng):
        """The r2f-only mtf_fidelity param reaches the kernel build: output
        differs from the parity default ONLY when sharpness is on (the
        signed kernel reshapes the MTF response; everything else is
        untouched, so sharpness=False must render identically)."""
        proc = Processor()
        kw = dict(print_film=PAPER, half_size=False, grain=0)
        a = proc.process(dng, PORTRA, **kw)
        b = proc.process(dng, PORTRA, mtf_fidelity=True, **kw)
        assert a.shape == b.shape and np.any(a != b)
        a0 = proc.process(dng, PORTRA, sharpness=False, **kw)
        b0 = proc.process(dng, PORTRA, sharpness=False, mtf_fidelity=True, **kw)
        np.testing.assert_array_equal(a0, b0)

    def test_full_effects_chain(self, dng):
        proc = Processor()
        out = proc.process(
            dng,
            PORTRA,
            print_film=PAPER,
            half_size=False,
            halation=True,
            grain=2,
            sharpness=True,
            highlight_burn=0.3,
            chroma_nr=1,
        )
        assert out.dtype == np.uint8

    def test_settings_roundtrip_reference_keys(self, dng):
        """A reference-style merged settings dict drives process() directly."""
        merged = merge_params(
            ProfileParams(negative_film="Kodak Ektar 100", print_film=None),
            ImageParams(exp_comp=0.5, rotate_times=1),
        )
        proc = Processor()
        out = proc.process(
            dng,
            merged.pop("negative_film"),
            print_film=merged.pop("print_film"),
            **merged,
        )
        assert out.dtype == np.uint8
        # rotate_times=1 swaps aspect
        assert out.shape[0] > out.shape[1]

    def test_resolution_and_canvas(self, dng):
        proc = Processor()
        out = proc.process(
            dng,
            PORTRA,
            print_film=PAPER,
            resolution=(48, 72),
            canvas_mode="Uniform black",
            canvas_scale=1.2,
            grain=0,
        )
        assert max(out.shape[:2]) <= 72

    def test_determinism_across_calls(self, dng):
        proc = Processor()
        kw = dict(print_film=PAPER, half_size=False, grain=2, seed=3)
        a = proc.process(dng, PORTRA, **kw)
        b = proc.process(dng, PORTRA, **kw)
        np.testing.assert_array_equal(a, b)


class TestExport:
    def test_jpeg_roundtrip_with_exif(self, tmp_path):
        from PIL import Image

        from raw2film_tpu.io.export import save_image

        img = (RNG.random((32, 48, 3)) * 255).astype(np.uint8)
        dst = str(tmp_path / "out.jpg")
        save_image(
            img,
            dst,
            quality=95,
            metadata={"EXIF:Make": "raw2film-tpu", "EXIF:ISO": 400},
            exp_comp=0.5,
        )
        back = Image.open(dst)
        exif = back.getexif()
        assert exif[271] == "raw2film-tpu"
        assert back.size == (48, 32)


class TestProcessBatch:
    def test_matches_single_renders(self):
        rng = np.random.default_rng(0)
        imgs = [
            np.abs(rng.normal(0.2, 0.1, (3, 48, 72))).astype(np.float32)
            for _ in range(3)
        ]
        proc = Processor()
        kw = dict(
            print_film="Kodak 2383", grain=0, halation=False, sharpness=False,
            half_size=False, max_scale=None,
        )
        batch = proc.process_batch(imgs, "Kodak Portra 400", **kw)
        for img, out in zip(imgs, batch):
            single = proc.process(img, "Kodak Portra 400", **kw)
            np.testing.assert_array_equal(out, single)

    def test_grain_parity_and_bucket_composition_determinism(self):
        """Per-image grain keys are fold_in(seed, position-in-srcs):

        * a single-image process() equals position 0 of a batch, grain
          included;
        * an image's render never depends on HOW the other images bucket by
          shape (changing a neighbor's shape regroups the buckets but must
          not touch this image's pixels).
        """
        rng = np.random.default_rng(7)
        small = lambda: np.abs(rng.normal(0.2, 0.1, (3, 48, 72))).astype(np.float32)  # noqa: E731
        a, c = small(), small()
        b_big = np.abs(rng.normal(0.2, 0.1, (3, 64, 96))).astype(np.float32)
        b_small = small()
        proc = Processor()
        kw = dict(
            print_film=None, grain=2, halation=False, sharpness=False,
            half_size=False, max_scale=None, seed=11,
        )
        # [a, b_big, c] buckets as {a, c} + {b_big}; [a, b_small, c] buckets
        # as one group of three. a (position 0) and c (position 2) keep
        # their keys either way.
        split_buckets = proc.process_batch([a, b_big, c], "Kodak Portra 400", **kw)
        one_bucket = proc.process_batch([a, b_small, c], "Kodak Portra 400", **kw)
        np.testing.assert_array_equal(split_buckets[0], one_bucket[0])
        np.testing.assert_array_equal(split_buckets[2], one_bucket[2])
        # Grain really ran (a differs from c even though both draw from the
        # same noise program — different fold_in positions).
        assert not np.array_equal(split_buckets[0], split_buckets[2])

        single = proc.process(a, "Kodak Portra 400", **kw)
        np.testing.assert_array_equal(single, split_buckets[0])

    def test_aspect_window_matches_crop_to_aspect(self):
        """The fused path's precomputed crop window must equal
        geometry.crop_to_aspect for EVERY branch: portrait/landscape/square,
        narrower and wider than the target aspect."""
        from raw2film_tpu.pipeline.geometry import crop_to_aspect
        from raw2film_tpu.pipeline.processor import _aspect_crop_window

        from raw2film_tpu.pipeline.processor import _staged_crop_window

        shapes = [
            (40, 60), (60, 40), (50, 50), (40, 41), (41, 40),
            (30, 90), (90, 30), (36, 54), (54, 36), (24, 65), (64, 64),
        ]
        for h, w in shapes:
            for aspect in (1.5, 1.0, 2.7, 65 / 24):
                img = np.arange(h * w, dtype=np.float32).reshape(1, h, w)
                want = crop_to_aspect(img, aspect)
                rows, cols = _aspect_crop_window(h, w, aspect)
                got = img[:, rows, cols]
                assert got.shape == want.shape, (h, w, aspect, got.shape, want.shape)
                np.testing.assert_array_equal(got, want)
                # The staged pipeline applies the crop TWICE (around the
                # rotate step); the composed window must match that too.
                want2 = crop_to_aspect(want, aspect)
                rows2, cols2 = _staged_crop_window(h, w, aspect)
                got2 = img[:, rows2, cols2]
                assert got2.shape == want2.shape, (h, w, aspect)
                np.testing.assert_array_equal(got2, want2)

    def test_fused_decode_square_mosaic_matches_staged(self, tmp_path):
        """Square inputs exercise both the transcription's final branch and
        the non-idempotent double crop."""
        from raw2film_tpu.io.dng import write_dng

        sq = (
            8000 + np.random.default_rng(1).integers(0, 30000, (64, 64))
        ).astype(np.uint16)
        p = str(tmp_path / "sq.dng")
        write_dng(p, sq, white_level=60000)
        proc = Processor()
        kw = dict(print_film=None, grain=0, halation=False, sharpness=False,
                  half_size=False, max_scale=None)
        fast, _ = proc._try_load_mosaic(p, dict(half_size=False, max_scale=None))
        assert fast is not None
        f = proc.process_batch([p], "Kodak Portra 400", **kw)
        s = proc.process_batch([p], "Kodak Portra 400", fused_decode=False, **kw)
        assert f[0].shape == s[0].shape
        d = np.abs(f[0].astype(np.int32) - s[0].astype(np.int32))
        assert d.max() <= 2, d.max()

    def test_fused_decode_matches_staged_path(self, tmp_path):
        """File sources with no geometry/lens/NR work take the fused-mosaic
        path (demosaic + camera matrix + exposure inside the render
        program). The aspect crop is exact (even-aligned superset + static
        post-demosaic window); the only differences left are the half-size
        exposure-estimator sample (~0.01 stop) and f32 association."""
        import os

        from raw2film_tpu.io.dng import write_dng

        rng = np.random.default_rng(11)
        srcs = []
        for i in range(2):
            yy, xx = np.mgrid[0:60, 0:94]
            m = (
                6000
                + 9000 * np.abs(np.sin(xx / 11.0 + i)) * np.abs(np.cos(yy / 7.0))
                + rng.integers(0, 500, (60, 94))
            ).astype(np.uint16)
            p = str(tmp_path / f"{i}.dng")
            write_dng(p, m, white_level=60000)
            srcs.append(p)
        proc = Processor()
        kw = dict(
            print_film=None, grain=0, halation=False, sharpness=False,
            half_size=False, max_scale=None,
        )
        # Guard against vacuity: the sources must actually be fused-eligible.
        load_kw = dict(half_size=False, max_scale=None)
        fast, _ = proc._try_load_mosaic(srcs[0], load_kw)
        assert fast is not None
        fused = proc.process_batch(srcs, "Kodak Portra 400", **kw)
        staged = proc.process_batch(
            srcs, "Kodak Portra 400", fused_decode=False, **kw
        )
        assert os.path.exists(srcs[0])
        for f, s in zip(fused, staged):
            assert f.shape == s.shape
            d = np.abs(f.astype(np.int32) - s.astype(np.int32))
            assert d.max() <= 2, d.max()
            assert np.mean(d) <= 1.0, np.mean(d)

    def test_process_single_image_takes_fused_path(self, tmp_path):
        """Single-image process() routes eligible sources through the fused
        mosaic program (the CLI batch-export configuration: a 45MP frame
        uploads 90 MB of u16 codes instead of 540 MB of decoded f32 XYZ):
        matches the staged path within the documented 2-code bound, matches
        process_batch position 0 bit-for-bit, and accepts an already-decoded
        RawImage (the decode-pool handoff) identically."""
        from raw2film_tpu.io.dng import read_raw, write_dng

        rng = np.random.default_rng(11)
        yy, xx = np.mgrid[0:60, 0:94]
        m = (
            6000
            + 9000 * np.abs(np.sin(xx / 11.0)) * np.abs(np.cos(yy / 7.0))
            + rng.integers(0, 500, (60, 94))
        ).astype(np.uint16)
        p = str(tmp_path / "t.dng")
        write_dng(p, m, white_level=60000)
        proc = Processor()
        kw = dict(print_film=None, grain=0, halation=False, sharpness=False,
                  half_size=False, max_scale=None)
        fused = proc.process(p, "Kodak Portra 400", **kw)
        staged = proc.process(p, "Kodak Portra 400", fused_decode=False, **kw)
        assert fused.shape == staged.shape
        d = np.abs(fused.astype(np.int32) - staged.astype(np.int32))
        assert d.max() <= 2 and np.mean(d) <= 1.0, (d.max(), np.mean(d))
        # RawImage input (CLI decode pool) is identical and fast-eligible.
        raw = read_raw(p)
        fast, parsed = proc._try_load_mosaic(
            raw, dict(half_size=False, max_scale=None)
        )
        assert fast is not None and parsed is raw
        np.testing.assert_array_equal(
            proc.process(raw, "Kodak Portra 400", **kw), fused
        )
        # Exporters read EXIF through the processor on the fast path too.
        assert isinstance(proc.last_metadata, dict) and proc.last_metadata
        # Batch position-0 equivalence (grain keys fold identically).
        np.testing.assert_array_equal(
            proc.process_batch([p], "Kodak Portra 400", **kw)[0], fused
        )

    def test_process_fused_path_honors_decode_cache(self, tmp_path, monkeypatch):
        """Repeat process() calls on the same path must not re-decode the
        file (round-5 review: the fused fast path bypassed both cache
        layers, costing a multi-second host decode per call — e.g. one
        photo rendered through several stocks). cache=False opts out."""
        from raw2film_tpu.io import dng as dng_mod
        from raw2film_tpu.io.dng import write_dng

        m = (
            2000
            + np.random.default_rng(3).integers(0, 30000, (40, 64))
        ).astype(np.uint16)
        p = str(tmp_path / "c.dng")
        write_dng(p, m, white_level=60000)

        calls = {"n": 0}
        real = dng_mod.read_raw

        def counting(path, *a, **k):
            calls["n"] += 1
            return real(path, *a, **k)

        monkeypatch.setattr(dng_mod, "read_raw", counting)
        # io/raw.py binds read_raw at import time — patch that name too so
        # the staged fallback's decodes are counted as well.
        from raw2film_tpu.io import raw as raw_mod

        monkeypatch.setattr(raw_mod, "read_raw", counting)
        proc = Processor()
        kw = dict(print_film=None, grain=0, halation=False, sharpness=False,
                  half_size=False, max_scale=None)
        first = proc.process(p, "Kodak Portra 400", **kw)
        n_first = calls["n"]
        assert n_first >= 1
        # Same source, different stock: decode must come from the cache.
        proc.process(p, "Fuji Crystal Archive Maxima", **kw)
        assert calls["n"] == n_first
        # Bit-identical repeat with the same stock.
        np.testing.assert_array_equal(
            proc.process(p, "Kodak Portra 400", **kw), first
        )
        assert calls["n"] == n_first
        # cache=False forces a fresh decode.
        proc.process(p, "Kodak Portra 400", cache=False, **kw)
        assert calls["n"] > n_first
        # A different geometry knob changes the key -> fresh decode, and the
        # staged fallback result is itself cached on the repeat call.
        kw2 = dict(kw, rotate_times=1)
        n_before = calls["n"]
        proc.process(p, "Kodak Portra 400", **kw2)
        assert calls["n"] > n_before

    def test_device_u16_normalization_matches_host(self):
        """The fused path's on-device (u16 - black) * inv normalization is
        bit-identical to the host f32 normalization it replaced."""
        import jax

        from raw2film_tpu.pipeline.render import render_chain_from_mosaic
        from raw2film_tpu.pipeline.processor import (
            build_render_config, Processor,
        )

        rng = np.random.default_rng(5)
        m16 = rng.integers(400, 60000, (32, 48)).astype(np.uint16)
        black, white = 512.0, 60000.0
        inv = 1.0 / (white - black)
        host = np.clip((m16.astype(np.float32) - black) * inv, 0.0, 1.0)
        proc = Processor()
        from raw2film_tpu.film.loader import load_film_stocks

        neg = load_film_stocks()["Kodak Portra 400"]
        merged = dict(
            exp_kelvin=6500.0, tint=0.0, exp_comp=0.0, push_pull=0.0,
            color_masking=1.0, red_light=0.0, green_light=0.0,
            blue_light=0.0, projector_kelvin=6500.0, shadow_comp=0.0,
            sat_adjust=1.0, inversion_gamma=4.0, idealized_curve=False,
            inversion=False, white_balance=False, white_clip=False,
            gamma_func="sRGB", halation_intensity=1.0,
            halation_green_factor=0.4, highlight_burn=0.0, halation=False,
            halation_size=1.0, sharpness=False, sharpening_strength=0.0,
            sharpening_sigma=1.0, grain=0, grain_size=6.0, grain_sigma=0.4,
            burn_scale=50.0, chroma_nr=0, mtf_fidelity=False,
        )
        bundle, prt_mode = proc.load_film_bundle(neg, None, merged)
        cfg = build_render_config(neg, None, prt_mode, 2.0, merged)
        key = jax.random.PRNGKey(0)
        cam = np.eye(3, dtype=np.float32)
        a = np.asarray(render_chain_from_mosaic(
            jnp.asarray(host), cam, bundle, cfg, key, "RGGB", 1.0, None
        ))
        b = np.asarray(render_chain_from_mosaic(
            jnp.asarray(m16), cam, bundle, cfg, key, "RGGB", 1.0, None,
            jnp.asarray([black, inv], jnp.float32),
        ))
        np.testing.assert_array_equal(a, b)

    def test_mixed_shapes_bucketed(self):
        rng = np.random.default_rng(1)
        imgs = [
            np.abs(rng.normal(0.2, 0.1, (3, 48, 72))).astype(np.float32),
            np.abs(rng.normal(0.2, 0.1, (3, 64, 96))).astype(np.float32),
            np.abs(rng.normal(0.2, 0.1, (3, 48, 72))).astype(np.float32),
        ]
        proc = Processor()
        outs = proc.process_batch(
            imgs, "Kodak Portra 400", print_film=None, grain=0, halation=False,
            sharpness=False, half_size=False, max_scale=None,
        )
        assert outs[0].shape == outs[2].shape != outs[1].shape

    def test_sharded_over_mesh(self):
        import jax as _jax

        if len(_jax.devices()) < 8:
            import pytest

            pytest.skip("needs 8 virtual devices")
        from raw2film_tpu.parallel.mesh import make_mesh

        rng = np.random.default_rng(2)
        imgs = [
            np.abs(rng.normal(0.2, 0.1, (3, 48, 72))).astype(np.float32)
            for _ in range(5)  # not divisible by mesh batch -> exercises pad
        ]
        proc = Processor()
        kw = dict(print_film=None, grain=0, halation=False, sharpness=False,
                  half_size=False, max_scale=None)
        plain = proc.process_batch(imgs, "Kodak Portra 400", **kw)
        sharded = proc.process_batch(
            imgs, "Kodak Portra 400", mesh=make_mesh(8, batch=8, space=1), **kw
        )
        for a, b in zip(plain, sharded):
            np.testing.assert_array_equal(a, b)

    def test_sharded_trailing_group_smaller_than_mesh(self):
        """2 images on an 8-wide batch axis: pad (6) > b (2) must tile."""
        import jax as _jax

        if len(_jax.devices()) < 8:
            import pytest

            pytest.skip("needs 8 virtual devices")
        from raw2film_tpu.parallel.mesh import make_mesh

        rng = np.random.default_rng(3)
        imgs = [
            np.abs(rng.normal(0.2, 0.1, (3, 48, 72))).astype(np.float32)
            for _ in range(2)
        ]
        proc = Processor()
        kw = dict(print_film=None, grain=0, halation=False, sharpness=False,
                  half_size=False, max_scale=None)
        plain = proc.process_batch(imgs, "Kodak Portra 400", **kw)
        sharded = proc.process_batch(
            imgs, "Kodak Portra 400", mesh=make_mesh(8, batch=8, space=1), **kw
        )
        for a, b in zip(plain, sharded):
            np.testing.assert_array_equal(a, b)

    def test_make_mesh_too_many_devices_raises(self):
        from raw2film_tpu.parallel.mesh import make_mesh
        import pytest

        with pytest.raises(ValueError, match="devices requested"):
            make_mesh(1024)


class TestRenderFromMosaic:
    def test_matches_staged_decode_then_render(self):
        """The fused mosaic entry (camera matrix folded into m_in) must
        match demosaic -> matrix -> render_chain to <=1 code (the fold only
        changes f32 association order)."""
        from raw2film_tpu.data import REC709_TO_XYZ
        from raw2film_tpu.ops import demosaic as dm
        from raw2film_tpu.pipeline.render import render_chain_from_mosaic

        rng = np.random.default_rng(5)
        mosaic = jnp.asarray(
            np.clip(rng.normal(0.3, 0.15, (64, 96)), 0, 1).astype(np.float32)
        )
        cam = jnp.asarray(REC709_TO_XYZ, jnp.float32)
        neg_p = fchain.build_negative_params(PORTRA)
        prt_p = fchain.build_print_params(PORTRA, PAPER, neg_params=neg_p)
        out_p = fchain.build_output_params(PORTRA, PAPER, prt_p, neg_p)
        bundle = make_film_bundle(neg_p, prt_p, out_p)
        merged = _merged(grain=0)
        cfg = build_render_config(PORTRA, PAPER, prt_p.mode, 64 / 36, merged)
        key = jax.random.PRNGKey(0)

        fused = np.asarray(render_chain_from_mosaic(mosaic, cam, bundle, cfg, key))
        rgb = jnp.clip(dm.demosaic_mhc(mosaic, "RGGB"), 0.0, 1.0)
        xyz = jnp.einsum(
            "ij,jhw->ihw", cam, rgb, precision=jax.lax.Precision.HIGHEST
        )
        from raw2film_tpu.pipeline.render import render_jit

        staged = np.asarray(render_jit(xyz, bundle, cfg, key))
        diff = np.abs(fused.astype(np.int32) - staged.astype(np.int32))
        assert diff.max() <= 1, diff.max()

    def test_exposure_gain_folds(self):
        """exposure_gain must act like pre-scaling the XYZ input."""
        from raw2film_tpu.data import REC709_TO_XYZ
        from raw2film_tpu.pipeline.render import render_chain_from_mosaic

        rng = np.random.default_rng(6)
        mosaic = jnp.asarray(
            np.clip(rng.normal(0.1, 0.05, (32, 64)), 0, 1).astype(np.float32)
        )
        cam = jnp.asarray(REC709_TO_XYZ, jnp.float32)
        neg_p = fchain.build_negative_params(PORTRA)
        prt_p = fchain.build_print_params(PORTRA, PAPER, neg_params=neg_p)
        out_p = fchain.build_output_params(PORTRA, PAPER, prt_p, neg_p)
        bundle = make_film_bundle(neg_p, prt_p, out_p)
        merged = _merged(grain=0, halation=False, sharpness=False)
        cfg = build_render_config(PORTRA, PAPER, prt_p.mode, 64 / 36, merged)
        key = jax.random.PRNGKey(0)
        dark = np.asarray(render_chain_from_mosaic(mosaic, cam, bundle, cfg, key))
        bright = np.asarray(
            render_chain_from_mosaic(
                mosaic, cam, bundle, cfg, key, exposure_gain=4.0
            )
        )
        assert bright.mean() > dark.mean() + 10


def test_fused_mosaic_rejects_chroma_nr():
    """Round-5 review regression: the fused path folds cam_to_xyz into m_in,
    so render_chain's chroma-NR stage would run on camera RGB — it must
    refuse rather than silently diverge from the staged path."""
    import jax
    import jax.numpy as jnp

    from raw2film_tpu.pipeline.render import RenderConfig, render_chain_from_mosaic

    cfg = RenderConfig(scale=100.0, chroma_nr=2)
    mosaic = jnp.zeros((8, 8), jnp.uint16)
    with pytest.raises(ValueError, match="chroma_nr"):
        render_chain_from_mosaic(
            mosaic, np.eye(3, dtype=np.float32), {}, cfg,
            jax.random.PRNGKey(0), "RGGB", 1.0,
        )
