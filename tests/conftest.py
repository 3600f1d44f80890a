"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The tests validate math and sharding on the host CPU so they run anywhere
(and exercise multi-device code paths via jax.sharding over the virtual
devices); device timing happens on the GPU through chip_smoke.py and the
benchmarks. The config is updated as well as the environment in case jax
was imported before this file (backends are not initialized until first
use, so this is still in time).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
