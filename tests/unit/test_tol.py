"""Solve-to-tolerance (cfg.tol > 0): on-device early stopping.

The while_loop checks the max u/v update per block; correctness rungs:
(1) a tol solve lands at the same flow as running the full budget when
tol is unreachable (budget-cap semantics are exact block multiples);
(2) a reachable tol stops early yet matches the converged fixed-point
flow to the tolerance's order; (3) every solver works under tol; (4)
config guards.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from hsflow.config import HSConfig
from hsflow.solver import hs_solve


def _frames(h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    return (jnp.asarray(rng.uniform(0, 1, (h, w)).astype(np.float32)),
            jnp.asarray(rng.uniform(0, 1, (h, w)).astype(np.float32)))


def test_unreachable_tol_equals_budget_run():
    i1, i2 = _frames()
    # tol=1e-30 never fires -> exactly iters sweeps in block_sweeps chunks.
    ft = hs_solve(i1, i2, HSConfig(alpha=0.5, iters=32, tol=1e-30,
                                   block_sweeps=16, backend="jnp"))
    ff = hs_solve(i1, i2, HSConfig(alpha=0.5, iters=32,
                                   block_sweeps=16, backend="jnp"))
    assert float(jnp.abs(ft.u - ff.u).max()) == 0.0
    assert float(jnp.abs(ft.v - ff.v).max()) == 0.0


def test_reachable_tol_matches_converged_flow():
    from hsflow.data.synthetic import translation_pair

    i1, i2, _ = translation_pair(48, 64, 1.0, 0.0, key=5)
    i1, i2 = jnp.asarray(i1), jnp.asarray(i2)
    conv = hs_solve(i1, i2, HSConfig(alpha=0.5, iters=4000, backend="jnp"))
    tl = hs_solve(i1, i2, HSConfig(alpha=0.5, iters=4000, tol=1e-5,
                                   backend="jnp"))
    # per-block delta <= 1e-5 implies the remaining distance to the fixed
    # point is O(tol / (1 - rho)); allow two orders.
    assert float(jnp.abs(tl.u - conv.u).max()) <= 1e-3
    assert float(jnp.abs(tl.v - conv.v).max()) <= 1e-3


@pytest.mark.parametrize("solver,backend", [
    ("jacobi", "pallas"),
    ("sor", "pallas"),
    ("multigrid", "jnp"),
])
def test_tol_runs_on_every_solver(solver, backend, kernel_mode):
    i1, i2 = _frames(seed=3)
    cfg = HSConfig(alpha=0.5, iters=64, tol=1e-4, solver=solver,
                   omega=1.5, backend=backend)
    f = hs_solve(i1, i2, cfg)
    assert np.isfinite(np.asarray(f.u)).all()
    assert float(jnp.abs(f.u).max()) > 0


def test_pyramid_tol_unreachable_equals_budget_run():
    """tol flows through hs_pyramid (per-level budgets): an unreachable tol
    runs every level's full budget in block_sweeps chunks -> identical to
    the fixed-count pyramid."""
    from hsflow.config import PyramidConfig
    from hsflow.data.synthetic import translation_pair
    from hsflow.pyramid import hs_pyramid

    i1, i2, _ = translation_pair(64, 96, 3.0, 0.0, key=9)
    i1, i2 = jnp.asarray(i1), jnp.asarray(i2)
    pyr = PyramidConfig(levels=3, iters_per_level=(16, 16, 32))
    ft = hs_pyramid(i1, i2, HSConfig(alpha=0.5, tol=1e-30, block_sweeps=8,
                                     backend="jnp"), pyr)
    ff = hs_pyramid(i1, i2, HSConfig(alpha=0.5, block_sweeps=8,
                                     backend="jnp"), pyr)
    assert float(jnp.abs(ft.u - ff.u).max()) == 0.0


def test_pyramid_tol_stops_early():
    from hsflow.config import PyramidConfig
    from hsflow.data.synthetic import translation_pair
    from hsflow.metrics import epe, interior
    from hsflow.pyramid import hs_pyramid

    i1, i2, gt = translation_pair(64, 96, 3.0, 0.0, key=9)
    i1, i2 = jnp.asarray(i1), jnp.asarray(i2)
    pyr = PyramidConfig(levels=3)
    cfg = HSConfig(alpha=0.5, iters=512, tol=5e-3, block_sweeps=4,
                   backend="jnp")
    ft = hs_pyramid(i1, i2, cfg, pyr)
    ff = hs_pyramid(i1, i2, HSConfig(alpha=0.5, iters=512, block_sweeps=4,
                                     backend="jnp"), pyr)
    assert float(jnp.abs(ft.u - ff.u).max()) > 0  # genuinely stopped early
    f = np.stack([np.asarray(ft.u), np.asarray(ft.v)], -1)
    assert epe(interior(f, 8), interior(gt, 8)) < 0.5  # still a good flow


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
def test_batched_tol_unreachable_equals_budget(backend, kernel_mode):
    """Both batched routes (batch-axis kernel / vmap) honor tol: an
    unreachable tol reproduces the fixed-budget stack exactly."""
    from hsflow.batch import hs_solve_batched

    i1a, i2a = _frames(seed=1)
    i1b, i2b = _frames(seed=2)
    b1 = jnp.stack([i1a, i1b])
    b2 = jnp.stack([i2a, i2b])
    ft = hs_solve_batched(b1, b2, HSConfig(alpha=0.5, iters=32, tol=1e-30,
                                           block_sweeps=8, backend=backend))
    ff = hs_solve_batched(b1, b2, HSConfig(alpha=0.5, iters=32,
                                           block_sweeps=8, backend=backend))
    assert float(jnp.abs(ft.u - ff.u).max()) == 0.0
    assert float(jnp.abs(ft.v - ff.v).max()) == 0.0


def test_batched_tol_stops_early():
    from hsflow.batch import hs_solve_batched
    from hsflow.data.synthetic import translation_pair

    i1, i2, _ = translation_pair(32, 64, 1.0, 0.5, key=11)
    b1 = jnp.stack([jnp.asarray(i1)] * 2)
    b2 = jnp.stack([jnp.asarray(i2)] * 2)
    ft = hs_solve_batched(b1, b2, HSConfig(alpha=0.5, iters=256, tol=1e-2,
                                           block_sweeps=2, backend="jnp"))
    ff = hs_solve_batched(b1, b2, HSConfig(alpha=0.5, iters=256,
                                           block_sweeps=2, backend="jnp"))
    assert float(jnp.abs(ft.u - ff.u).max()) > 0
    # Identical pairs -> identical per-lane flows under the global stop.
    assert float(jnp.abs(ft.u[0] - ft.u[1]).max()) == 0.0


def test_config_guards():
    with pytest.raises(ValueError, match="tol"):
        HSConfig(tol=-1.0)
    with pytest.raises(ValueError, match="mutually exclusive"):
        HSConfig(tol=1e-4, checkpoint_every=8)
