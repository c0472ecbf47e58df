"""Test configuration: the CPU with 8 virtual devices, so the sharding
tests run anywhere. XLA_FLAGS must be set before JAX is imported.

`chip_smoke.py` runs the end-to-end checks on the card.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-frame end-to-end parity runs")
