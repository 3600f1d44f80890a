"""raw2film-tpu: a JAX/XLA analog-film emulation framework.

Re-implements the full capability surface of the reference desktop application
(RAW decode -> linear CIE-XYZ -> spectral negative/print film chain -> film
effects -> display RGB export) as a single functional, jit-compiled pixel
pipeline for an accelerator (an NVIDIA GPU):

- planar ``(3, H, W)`` float32 image layout (each channel a contiguous
  plane, so 3x3 channel mixes are scalar mul-adds over planes),
- LUT *construction* (the film science) on host NumPy, LUT *application* and
  all per-pixel work on device,
- one pipeline serving both interactive preview and batch export (the
  reference duplicates its pipeline across a CPU and a WebGPU engine,
  reference: src/raw2film/cpu_processor.py:269-414 and
  src/raw2film/gpu_processor.py:1695-1890),
- batch export scales across chips by sharding the *image batch* over a
  ``jax.sharding.Mesh``.
"""

from raw2film_tpu._version import __version__
from raw2film_tpu.film.stock import FilmStock
from raw2film_tpu.film.loader import camera_stocks, load_film_stocks, print_stocks
from raw2film_tpu.pipeline.params import ImageParams, ProfileParams, merge_params
from raw2film_tpu.pipeline.processor import Processor

R2F_BASE_DIR = __path__[0]


def __getattr__(name):  # lazy: these pull in threading/io machinery
    if name == "PreviewEngine":
        from raw2film_tpu.pipeline.preview import PreviewEngine

        return PreviewEngine
    if name == "BatchRunner":
        from raw2film_tpu.pipeline.batch import BatchRunner

        return BatchRunner
    if name == "render_chain_from_mosaic":
        from raw2film_tpu.pipeline.render import render_chain_from_mosaic

        return render_chain_from_mosaic
    raise AttributeError(name)


__all__ = [
    "__version__",
    "FilmStock",
    "load_film_stocks",
    "camera_stocks",
    "print_stocks",
    "Processor",
    "ProfileParams",
    "ImageParams",
    "merge_params",
    "PreviewEngine",
    "BatchRunner",
    "render_chain_from_mosaic",
    "R2F_BASE_DIR",
]
