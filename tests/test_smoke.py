"""Smoke test: the reference's whole-app launch check, reimagined headless.

The reference's only CI test constructs the full app (film DB + both engines
+ all GPU pipelines) offscreen (reference: tests/smoke_test.py:1-6). Our
equivalent: import every public module, load the stock DB, build a Processor,
and push a synthetic RAW end-to-end through the default configuration to a
JPEG on disk.
"""

import importlib
import os

import numpy as np


PUBLIC_MODULES = [
    "raw2film_tpu",
    "raw2film_tpu.config",
    "raw2film_tpu.data",
    "raw2film_tpu.cli",
    "raw2film_tpu.viewer",
    "raw2film_tpu.film",
    "raw2film_tpu.film.chain",
    "raw2film_tpu.film.grain",
    "raw2film_tpu.film.loader",
    "raw2film_tpu.film.luts",
    "raw2film_tpu.film.sensitometry",
    "raw2film_tpu.film.spectra",
    "raw2film_tpu.film.stock",
    "raw2film_tpu.film.swatches",
    "raw2film_tpu.film.transfer",
    "raw2film_tpu.io.cube",
    "raw2film_tpu.io.dng",
    "raw2film_tpu.io.export",
    "raw2film_tpu.io.icc",
    "raw2film_tpu.io.lens",
    "raw2film_tpu.io.lensfun_convert",
    "raw2film_tpu.io.ljpeg",
    "raw2film_tpu.io.raw",
    "raw2film_tpu.io.thumbnail",
    "raw2film_tpu.native",
    "raw2film_tpu.ops.burn",
    "raw2film_tpu.ops.chroma_nr",
    "raw2film_tpu.ops.conv",
    "raw2film_tpu.ops.demosaic",
    "raw2film_tpu.ops.fastmath",
    "raw2film_tpu.ops.grain",
    "raw2film_tpu.ops.halation",
    "raw2film_tpu.ops.histogram",
    "raw2film_tpu.ops.lut",
    "raw2film_tpu.ops.mtf",
    "raw2film_tpu.ops.resize",
    "raw2film_tpu.parallel.distributed",
    "raw2film_tpu.parallel.mesh",
    "raw2film_tpu.pipeline.batch",
    "raw2film_tpu.pipeline.canvas",
    "raw2film_tpu.pipeline.geometry",
    "raw2film_tpu.pipeline.params",
    "raw2film_tpu.pipeline.preview",
    "raw2film_tpu.pipeline.processor",
    "raw2film_tpu.pipeline.render",
    "raw2film_tpu.pipeline.settings",
    "raw2film_tpu.utils.trace",
]


def test_all_modules_import():
    for mod in PUBLIC_MODULES:
        importlib.import_module(mod)


def test_default_config_end_to_end(tmp_path):
    """Synthetic DNG -> default profile (Portra 400 -> Crystal Archive) ->
    JPEG with histogram — the reference smoke path with pixels checked."""
    from raw2film_tpu import Processor, load_film_stocks
    from raw2film_tpu.data import REC709_TO_XYZ, XYZ_TO_REC709
    from raw2film_tpu.io.dng import write_dng
    from raw2film_tpu.io.export import save_image
    from raw2film_tpu.ops.histogram import generate_histogram
    from raw2film_tpu.pipeline.params import ImageParams, ProfileParams, merge_params

    stocks = load_film_stocks()
    assert len(stocks) >= 20

    h, w = 96, 144
    yy, xx = np.mgrid[0:h, 0:w]
    rgb = np.stack([0.1 + 0.5 * xx / w, 0.12 + 0.4 * yy / h, 0.3 - 0.1 * xx / w], -1)
    cam = (rgb @ REC709_TO_XYZ.T) @ XYZ_TO_REC709.T
    mosaic = np.zeros((h, w))
    mosaic[0::2, 0::2] = cam[0::2, 0::2, 0]
    mosaic[0::2, 1::2] = cam[0::2, 1::2, 1]
    mosaic[1::2, 0::2] = cam[1::2, 0::2, 1]
    mosaic[1::2, 1::2] = cam[1::2, 1::2, 2]
    dng = str(tmp_path / "smoke.dng")
    write_dng(dng, np.clip(mosaic, 0, 1) * 60000, white_level=60000)

    merged = merge_params(ProfileParams(), ImageParams())
    merged.pop("profile")
    merged.pop("film_format")
    proc = Processor()
    out = proc.process(
        dng,
        merged.pop("negative_film"),
        print_film=merged.pop("print_film"),
        half_size=False,
        **merged,
    )
    assert out.dtype == np.uint8
    assert 10 < out.mean() < 245  # a plausible photograph, not black/white

    hist = generate_histogram(out.transpose(2, 0, 1))
    assert hist.shape == (100, 256, 4)

    dst = str(tmp_path / "smoke.jpg")
    save_image(out, dst, metadata={"EXIF:Make": "raw2film-tpu"}, exp_comp=0.0)
    assert os.path.getsize(dst) > 1000
