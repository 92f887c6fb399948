"""Test harness config: run everything on the CPU with 8 virtual devices,
so sharding paths compile and execute without an accelerator (chip_smoke.py
runs the same entry points on the GPU)."""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")

import jax  # noqa: E402

# an environment may pin JAX_PLATFORMS before this file runs; the config
# update after import wins, so tests always run on the virtual CPU mesh
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)

from drmlt_mitsuba.core.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def native_built():
    """Build native/ (cpu_oracle, exr_tool, the BVH library) from source
    once per worker; the binaries are host-specific and never committed."""
    from drmlt_mitsuba.utils.native import build_native

    build_native()


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """XLA's CPU compiler segfaults deep into a full-suite run (reproduced
    twice at ~190 tests, always inside backend_compile) — apparently from
    accumulated compilation state in one process.  Dropping the in-memory
    executable caches between modules avoids it; the persistent
    compilation cache keeps recompiles cheap."""
    yield
    import jax

    jax.clear_caches()
