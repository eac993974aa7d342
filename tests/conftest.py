"""Test configuration: CPU-only with a virtual 8-device mesh, float64 on.

All numerical parity tests run at f64 against numpy oracles; sharding tests
use the 8 virtual CPU devices.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# the config API pins tests to the virtual CPU devices even where an
# accelerator plugin is installed; JAX_PLATFORMS=cuda,cpu opens the card
# for the `gpu`-marked tests
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Persistent compilation cache: the suite triggers hundreds of XLA:CPU
# compiles in one process; caching them on disk makes reruns fast and
# avoids compiler-memory pressure in long single-process runs.
from rigidmultiblobswall_tpu.utils.cache import (  # noqa: E402
    enable_compilation_cache)

enable_compilation_cache()

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Tests marked `gpu` take this fixture: it skips unless JAX sees a
    CUDA GPU. Decided here, at run time, never while modules import."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a CUDA GPU (run on the card: see README)")
    return devices[0]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Bound in-process compiler state: the full suite triggers hundreds
    of XLA:CPU compiles and the accumulated JIT state has produced
    compiler segfaults deep into single-process runs. Dropping the
    in-memory executable cache after each module keeps the process lean;
    the persistent disk cache makes any re-compiles cheap."""
    yield
    jax.clear_caches()


# ---------------------------------------------------------------------------
# Test tiers: the full suite has outgrown casual
# verification on a 1-CPU host (test_ewald.py alone >9 min). Modules are
# auto-marked here so `-m "not slow and not e2e"` is a <5-minute core tier;
# individual tests can still add pytest.mark.slow/e2e themselves.
# ---------------------------------------------------------------------------
_SLOW_MODULES = {
    "test_ewald", "test_integrators", "test_lubrication", "test_rollers",
    "test_equilibrium", "test_fibers", "test_mcmc", "test_materialized",
    "test_articulated_rollers", "test_wall_spectral",
    # measured >35 s each on a 1-CPU host; moved out so the core tier
    # stays under ~5 minutes
    "test_source_target", "test_articulated",
    "test_wall_rot_engine",
}
_E2E_MODULES = {
    "test_reference_e2e", "test_published_examples", "test_cli",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        mod = item.module.__name__.rsplit(".", 1)[-1]
        if mod in _SLOW_MODULES:
            item.add_marker(pytest.mark.slow)
        if mod in _E2E_MODULES:
            item.add_marker(pytest.mark.e2e)
