"""Perf floors on the GPU (SURVEY.md §4 tests/perf); skipped without a card.

Not a benchmark — a regression tripwire: sweep throughput must stay above a
floor well below the measured number so noise doesn't flake the suite, and
the kernel must keep the lead over plain XLA that made it the GPU default.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hsflow.config import HSConfig
from hsflow.solver import hs_solve

pytestmark = pytest.mark.gpu


def _throughput(h, w, iters, backend, repeats=10):
    rng = np.random.default_rng(0)
    i1 = jnp.asarray(rng.uniform(0, 1, (h, w)).astype(np.float32))
    i2 = jnp.asarray(rng.uniform(0, 1, (h, w)).astype(np.float32))
    cfg = HSConfig(alpha=0.5, iters=iters, backend=backend)
    jax.block_until_ready(hs_solve(i1, i2, cfg))  # compile
    t0 = time.perf_counter()
    for _ in range(repeats):
        f = hs_solve(i1, i2, cfg)
    jax.block_until_ready(f)
    dt = (time.perf_counter() - t0) / repeats
    return h * w * iters / dt / 1e9


def test_pallas_sweep_floor():
    gpx = _throughput(1080, 1920, 100, "pallas")
    # measured ~62 Gpx*sweeps/s on an H200 at 700 W (PERF.md)
    assert gpx > 30.0, f"kernel sweep throughput regressed: {gpx:.1f} Gpx*sweeps/s"


def test_pallas_beats_jnp_at_mpx_scale():
    gp = _throughput(1080, 1920, 100, "pallas")
    gj = _throughput(1080, 1920, 100, "jnp")
    assert gp > 1.1 * gj, f"kernel {gp:.1f} should lead jnp {gj:.1f} by >10%"
