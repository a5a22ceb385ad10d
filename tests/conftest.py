"""Test env: force CPU with a virtual 8-device mesh (SURVEY.md §4: multi-chip
paths are validated on a xla_force_host_platform_device_count CPU mesh).

The platform is set with jax.config.update before any backend initializes,
so the tests run on the CPU (Pallas kernels in interpret mode) whatever
JAX_PLATFORMS says.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _bound_compile_cache():
    """Free compiled executables between test modules.

    The XLA:CPU backend intermittently SIGABRTs in backend_compile_and_load
    late in a long single-process run (reproduced twice at the ~50th test;
    every affected test passes in isolation). Bounding the in-process
    executable cache keeps the compiler's footprint flat at the cost of a
    few recompiles of shared shapes."""
    yield
    jax.clear_caches()
