import os

# smoke tests and benches must see ONE device (the dry-run sets its own 512
# in a separate process) — never set xla_force_host_platform_device_count here.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import pytest

jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="session")
def rng_key():
    return jax.random.key(0)


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_between_modules():
    """XLA's CPU ORC-JIT can fail to materialize symbols once a long-lived
    process accumulates dozens of compiled dylibs; dropping compiled
    executables between test modules keeps the count bounded."""
    yield
    jax.clear_caches()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the hand-written kernels); "
        "skips with a reason elsewhere")
