"""Test config: force a virtual 8-device CPU platform.

Multi-device sharding tests run on ``xla_force_host_platform_device_count=8``
virtual CPU devices; the GPU paths are exercised on the card by
``chip_smoke.py``.
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
# Tests are XLA-CPU compile-dominated (every factorization family traces
# its own kernels); skipping most optimization passes roughly halves the
# suite wall clock.  Semantics-preserving: all kernels are integer/exact,
# and the golden-parity assertions would catch any deviation.
jax.config.update("jax_disable_most_optimizations", True)
# No persistent compile cache for the CPU suite: it would fill the
# checkout with cache files that no GPU run can use.
jax.config.update("jax_enable_compilation_cache", False)

import pathlib

import pytest

GOLDEN = pathlib.Path(__file__).parent / "golden"


@pytest.fixture(scope="session")
def golden_dir() -> pathlib.Path:
    return GOLDEN
