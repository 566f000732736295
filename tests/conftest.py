"""Test harness config.

Tests run on the CPU, on a virtual 8-device mesh so multi-device sharding
paths are exercised without accelerators. What needs the GPU is marked
`gpu` and skips there; on the card, `JAX_PLATFORMS=cuda python -m pytest
-m gpu tests/` runs it, and `chip_smoke.py` covers the same checks.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

# the CPU unless the caller names a platform: `JAX_PLATFORMS=cuda pytest -m
# gpu tests/` runs the `gpu`-marked tests on the card
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

# Persistent compile cache: most suite time is XLA recompiling the same
# modem programs in every test process. `import gf3x` places the cache
# (`gf3x.compile_cache_dir()`); cache even the quicker compiles here.
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def pytest_addoption(parser):
    parser.addoption(
        "--slow", action="store_true", default=False,
        help="include tests marked slow (the full tier; also GF3X_SLOW=1)")


@pytest.fixture
def gpu():
    """Skip unless JAX sees a GPU (decided when the test runs, never at
    import or collection, so every xdist worker collects the same tests)."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip("needs a GPU (covered on the card by chip_smoke.py)")
    return devs[0]


def pytest_collection_modifyitems(config, items):
    """Two test tiers: the default run is the FAST tier
    — the 8 slowest breadth/duplication tests skip (each marker's comment
    names the sibling coverage that remains); `pytest --slow` (or
    GF3X_SLOW=1) runs everything — do that once per round."""
    if (config.getoption("--slow")
            or os.environ.get("GF3X_SLOW", "") not in ("", "0")):
        return
    skip = pytest.mark.skip(reason="slow tier: run with pytest --slow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
