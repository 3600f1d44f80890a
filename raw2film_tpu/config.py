"""Global configuration constants.

Mirrors the role of the reference's ``spectral_film_lut.config``
(reference: src/raw2film/raw_conversion.py:10 imports DEFAULT_DTYPE).
"""

import os

import numpy as np

DEFAULT_DTYPE = np.float32
"""Pipeline float dtype for host-side LUT construction and the device chain."""

LOG_EXPOSURE_MIN = -4.0
"""Lower edge of the log10-relative-exposure grid for H&D curves."""

LOG_EXPOSURE_MAX = 2.0
"""Upper edge of the log10-relative-exposure grid for H&D curves."""

DENSITY_CURVE_SIZE = 512
"""Samples in a 1D H&D density curve LUT."""

INPUT_LUT_SIZE = 128
"""Side length of the 2D chromaticity input LUT."""

PRINT_LUT_SIZE = 33
"""Side length of the 3D print/output LUT."""

LINEAR_SCALING = 4.0
"""Density-domain scale baked into the 3D LUT: LUT coords = density / 4
(reference: src/raw2film/cpu_processor.py:251 ``linear_scaling=4.0`` and
cpu_processor.py:405 ``apply_lut_tetrahedral(image, lut, 0.25)``)."""

LOG10_EPS = 1e-6
"""Clip floor before log10 (reference: shaders/lut_1d.wgsl safe_log10_vec3)."""


CACHE_DIR_ENV = "JAX_COMPILATION_CACHE_DIR"

JIT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)
"""Default persistent compile cache: one fixed path inside the checkout
(the path is part of the cache key, so a directory that moves never hits)."""


def jit_cache_dir() -> str | None:
    """The directory this process should point JAX's compile cache at, or
    None when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX then reads the
    variable itself and the program sets nothing)."""
    if os.environ.get(CACHE_DIR_ENV):
        return None
    return JIT_CACHE_DIR


def enable_persistent_jit_cache() -> None:
    """Point JAX's persistent compilation cache at :data:`JIT_CACHE_DIR` so a
    render configuration compiles once per checkout, not once per session
    (the reference's analogue is its 16 pre-built WGSL pipelines). Called
    by Processor on construction; safe to call repeatedly."""
    import jax

    cache = jit_cache_dir()
    if cache is None:
        return
    try:
        os.makedirs(cache, exist_ok=True)
    except OSError:
        return  # read-only install location: compile without the cache
    jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
