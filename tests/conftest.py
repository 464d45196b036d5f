"""Test configuration: CPU-simulated 8-device mesh + x64 parity mode.

The reference's tests run fp64 on a single device (SURVEY.md §4). Here we
additionally simulate a multi-device topology on CPU so the distributed
layer is unit-testable without several cards
(XLA_FLAGS=--xla_force_host_platform_device_count=8).

Tests run on the CPU unless JAX_PLATFORMS says otherwise: the tests marked
``gpu`` need the card and skip elsewhere; on the card's machine run them
with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`` (the CPU
backend stays listed: host callbacks and CPU staging need it).
"""

import os

# Must be set before jax import.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

from tpu_sparse.utils.compile_cache import setup_compile_cache  # noqa: E402

jax.config.update("jax_enable_x64", True)
setup_compile_cache()
# Persist only genuinely slow compiles. With min_compile_time 0 this host
# segfaults inside put_executable_and_time serializing certain tiny CPU
# executables (gather/scatter transpose programs), leaving truncated cache
# entries that then segfault on read in the next run.
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

import gc  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

_TESTS_RUN = 0


def pytest_runtest_teardown(item, nextitem):
    """Drop JAX executable caches every 40 tests.

    XLA:CPU keeps every compiled executable mmapped; across the full suite
    the process crosses vm.max_map_count (65530 default on this microVM)
    and XLA segfaults inside backend_compile (observed deterministically at
    ~153 tests, ~65k maps). Recompiles are amortized by the persistent
    disk cache.
    """
    global _TESTS_RUN
    _TESTS_RUN += 1
    if _TESTS_RUN % 40 == 0:
        jax.clear_caches()
        gc.collect()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first device, for tests marked ``gpu``; skips without a card.
    Decided here, at run time, never while a module is imported."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; this run's device is {dev.platform}")
    return dev
