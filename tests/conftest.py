"""Test harness: CPU backend with 8 virtual devices, f64 parity mode.

Multi-device sharding tests exercise pjit/shard_map collectives on a virtual
CPU mesh (no accelerator needed); f64 gives bit-parity with the float64 NumPy
reference oracle.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

# Tests run on the virtual CPU mesh even on a machine with a card.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: exhaustive sweep; the default run keeps a small "
        "representative, the full sweep runs with JPEG_TPU_SLOW_TESTS=1")


def pytest_collection_modifyitems(config, items):
    if os.environ.get("JPEG_TPU_SLOW_TESTS"):
        return
    skip = pytest.mark.skip(reason="set JPEG_TPU_SLOW_TESTS=1")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
