"""Test configuration: run on a virtual 8-device CPU mesh with x64 enabled.

Physics validation follows the reference's checksum strategy
(ref: tests/checksum/checksum.py) which requires double precision; the CPU
backend provides that while accelerator runs use f32 by default.

Tests that need a GPU carry the `gpu` marker and skip here; chip_smoke.py
runs the same paths on the card.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
