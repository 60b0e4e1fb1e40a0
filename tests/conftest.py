"""Test harness config: CPU JAX with 8 virtual devices, so the sharding tests
run without a multi-device machine (SURVEY.md §4d) and the suite never opens
a GPU. Must run before jax imports.

Tests marked ``gpu`` skip on the CPU. To run them on a GPU machine:
``FLUID_SIM_TESTS_ON_GPU=1 python -m pytest tests/ -m gpu``."""

import os
import sys

import pytest

# repo root on sys.path regardless of pytest's invocation dir: tests import
# tools/make_goldens.py (namespace package)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# hard-set (not setdefault): the suite runs on the CPU even on a GPU machine
if os.environ.get("FLUID_SIM_TESTS_ON_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

# Persistent compile cache: the suite re-jits the same small shapes each run.
import jax  # noqa: E402

from fluid_simulation.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)


@pytest.fixture
def gpu():
    """The GPU for tests marked ``gpu``; they skip when JAX runs on the
    CPU (see the module docstring)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (FLUID_SIM_TESTS_ON_GPU=1 on a GPU "
                    "machine); chip_smoke.py runs the same check there")
    return jax.devices()[0]
