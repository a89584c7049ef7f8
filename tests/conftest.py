"""Test-suite environment setup (SURVEY.md §4).

The suite runs on the CPU backend with 8 virtual devices — the standard JAX
fake-backend trick — so distributed tests can build real 1x8 / 2x4 / 8x1
meshes without a cluster. Tests marked `gpu` need an NVIDIA GPU and skip
here; on the card run them with

    HSFLOW_TEST_GPU=1 python -m pytest tests/ -m gpu -p no:xdist

(chip_smoke.py does exactly that in-process). Whether a card is present is
decided inside the autouse fixture below, never at import or collection.

This must execute before anything imports jax, which pytest guarantees for a
rootdir conftest.
"""

import os

ON_GPU = os.environ.get("HSFLOW_TEST_GPU", "0") == "1"

if not ON_GPU:
    # Backend initialization is lazy, so setting XLA_FLAGS plus the
    # jax_platforms config before the first device query works even if jax
    # was imported already.
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from hsflow.data.synthetic import synthetic_pair, WarpSpec  # noqa: E402


@pytest.hookimpl(tryfirst=True)
def pytest_cmdline_main(config):
    """Default the CPU suite to 4 xdist workers: one process accumulates
    hundreds of XLA CPU compiles x 8 fake devices; sharding the run across
    worker processes divides that pressure 4x. Must run BEFORE xdist's own
    (tryfirst) pytest_cmdline_main, which derives its worker transports
    from numprocesses — a conftest hook registers later and is therefore
    called first. Explicit -n/-n0 still wins; GPU runs stay in one process
    (one process per card)."""
    if ON_GPU:
        return
    if os.environ.get("PYTEST_XDIST_WORKER"):
        # Workers re-invoke pytest_cmdline_main after xdist resets
        # numprocesses/dist (xdist/remote.py setup_config); re-defaulting
        # here would turn every worker into a controller and hang the run.
        return
    n = getattr(config.option, "numprocesses", None)
    if n is None and not getattr(config.option, "collectonly", False):
        config.option.numprocesses = 4


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip `gpu`-marked tests unless this process runs on a GPU."""
    if request.node.get_closest_marker("gpu") is None:
        return
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (HSFLOW_TEST_GPU=1 on the card)")


@pytest.fixture
def kernel_mode():
    """Run backend="pallas" as the real GPU kernel on a card, else in the
    Pallas interpreter (the kernel module's test-only context)."""
    from hsflow.kernels.jacobi import interpret_mode

    if jax.default_backend() == "gpu":
        yield "gpu"
        return
    with interpret_mode():
        yield "interpret"


# -- memory-map guard (root cause of the round-2 single-process abort) --------
#
# Every XLA:CPU-compiled executable mmaps its LLVM JIT code sections, and the
# jit caches keep executables alive for the whole process. One process
# running the full suite on the 8-fake-device mesh accumulates mmaps toward
# the kernel's vm.max_map_count ceiling (65530 default); once mmap returns
# ENOMEM, LLVM hard-aborts ("Unable to allocate section memory!" — measured:
# ~28k maps two minutes into a -n0 run and climbing). It is JIT-code-section
# exhaustion in XLA:CPU, not a leak in this package or libhsio (map counts
# were flat over hundreds of small compiles; only the per-executable
# sections accumulate). Mitigations: xdist-4 divides the pressure per
# worker (the default, below), and this guard makes single-process -n0 runs
# finish by dropping the jit caches — freeing the executables and their
# sections — whenever the map count crosses a safety threshold.

_MAP_GUARD_LIMIT = int(os.environ.get("HSFLOW_MAP_GUARD", "45000"))


def _map_count() -> int:
    try:
        with open("/proc/self/maps", "rb") as fh:
            return sum(1 for _ in fh)
    except OSError:  # non-Linux: no /proc, and no map ceiling this low
        return 0


@pytest.hookimpl(trylast=True)
def pytest_runtest_teardown(item):
    if ON_GPU or _MAP_GUARD_LIMIT <= 0:
        return
    if _map_count() > _MAP_GUARD_LIMIT:
        jax.clear_caches()


@pytest.fixture(scope="session")
def n_devices() -> int:
    return jax.device_count()


@pytest.fixture(scope="session")
def small_translation_pair():
    """64x80 texture translated by (1, 0.5) px with analytic GT."""
    return synthetic_pair(64, 80, WarpSpec.translation(1.0, 0.5), key=7)


@pytest.fixture(scope="session")
def tiny_images():
    """Deterministic 8x8 float images for exact stencil-arithmetic checks."""
    rng = np.random.default_rng(0)
    i1 = rng.uniform(0.0, 1.0, (8, 8)).astype(np.float32)
    i2 = rng.uniform(0.0, 1.0, (8, 8)).astype(np.float32)
    return i1, i2
