"""Test config: force CPU with 8 virtual devices so sharding tests run anywhere.

Mirrors SURVEY.md §4: multi-device correctness is validated on an emulated
mesh (xla_force_host_platform_device_count=8), compared against the
single-device render. The platform is switched with jax.config.update, which
also works when jax was imported before this file runs.

Tests that only the GPU can run carry the `gpu` marker and take the `gpu`
fixture, which skips them here; chip_smoke.py runs the same comparisons on
the card (`python chip_smoke.py`).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from gltf_renderer.utils.cache import enable_compilation_cache  # noqa: E402

# The CPU test programs get their own subdirectory of the checkout's cache
# (or JAX_COMPILATION_CACHE_DIR when that is set).
enable_compilation_cache(subdir="cpu-tests")


# Fast high-signal tier: `pytest -m smoke` finishes in well under 90 s and
# covers the core math/RNG/BSDF/BVH/loader/light invariants — the gate to run
# per-iteration; the full suite (~10 min) stays the pre-commit/nightly bar.
SMOKE_MODULES = {
    "test_math", "test_rng", "test_bvh", "test_loader", "test_lights",
    "test_bsdf", "test_perf_structures", "test_scene_cache",
}


def pytest_collection_modifyitems(session, config, items):
    """Run test_ssim_baseline FIRST (its graphs are the biggest compiles —
    see the XLA:CPU crash note on _clear_jax_caches_per_module); auto-mark
    the smoke tier by module so the fast gate needs no per-test edits."""
    import pytest as _pytest

    for it in items:
        mod = it.nodeid.split("::")[0].rsplit("/", 1)[-1].removesuffix(".py")
        if mod in SMOKE_MODULES:
            it.add_marker(_pytest.mark.smoke)
    front = [it for it in items if "test_ssim_baseline" in it.nodeid]
    rest = [it for it in items if "test_ssim_baseline" not in it.nodeid]
    items[:] = front + rest


import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU. Decided when the test runs,
    never at import or collection, so every xdist worker collects the same
    tests."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this on the card")
    return jax.devices()[0]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop compiled executables after every test module.

    XLA:CPU in this environment reliably ABORTS/SEGFAULTS compiling a large
    program once ~100+ programs have been compiled and retained in one
    process (reproduced 7/7 at the same test POSITION across different
    modules, orderings, and with the persistent cache on/off; every test
    passes standalone). Bounding the number of live executables per process
    avoids the jaxlib resource bug; the per-module recompiles are mostly
    absorbed by the persistent cache.
    """
    yield
    jax.clear_caches()
