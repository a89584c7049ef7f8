"""Distributed solve-to-tolerance (cfg.tol > 0 in hs_solve_tiled).

The stop decision is a pmax over the mesh of per-shard masked max-updates,
taken every halo block. Rungs: (1) unreachable tol == fixed-budget tiled run
(budget-cap semantics); (2) tiled tol == untiled sweeps_until EXACTLY when
the block cadences match (Jacobi tiled == untiled, so deltas — and hence the
stopping block — are identical); (3) works on SOR and batched DP x TP; (4)
guards (iters < halo_sweeps).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from hsflow.config import HSConfig, MeshConfig
from hsflow.data.synthetic import translation_pair
from hsflow.dist import hs_solve_tiled, make_mesh
from hsflow.solver import hs_solve


@pytest.fixture(scope="module")
def pair():
    i1, i2, _ = translation_pair(32, 64, 1.0, 0.5, key=11)
    return jnp.asarray(i1), jnp.asarray(i2)


def test_unreachable_tol_equals_fixed_budget(pair):
    i1, i2 = pair
    mesh = make_mesh(MeshConfig(batch=1, y=2, x=2))
    cfg_t = HSConfig(alpha=0.5, iters=24, tol=1e-30, backend="jnp")
    cfg_f = HSConfig(alpha=0.5, iters=24, backend="jnp")
    ft = hs_solve_tiled(i1, i2, cfg_t, mesh=mesh, halo_sweeps=3)
    ff = hs_solve_tiled(i1, i2, cfg_f, mesh=mesh, halo_sweeps=3)
    assert float(jnp.abs(ft.u - ff.u).max()) == 0.0
    assert float(jnp.abs(ft.v - ff.v).max()) == 0.0


@pytest.mark.parametrize("my,mx,s", [(2, 2, 2), (1, 8, 4), (4, 2, 1)])
def test_tiled_tol_matches_untiled_tol(pair, my, mx, s):
    """Same check cadence (halo_sweeps == block_sweeps) -> same deltas ->
    same stopping block -> same flow, to float tolerance."""
    i1, i2 = pair
    mesh = make_mesh(MeshConfig(batch=1, y=my, x=mx))
    # Measured block deltas on this pair: 1e-2 is first crossed at iter
    # ~50 (cadence 1) to ~150 (cadence 4), so every cadence stops early;
    # tighter tols exhaust the 256 budget at cadence 4 and the early-stop
    # assertion below would be vacuous.
    cfg = HSConfig(alpha=0.5, iters=256, tol=1e-2, block_sweeps=s,
                   backend="jnp")
    ft = hs_solve_tiled(i1, i2, cfg, mesh=mesh, halo_sweeps=s)
    fu = hs_solve(i1, i2, cfg)
    np.testing.assert_allclose(np.asarray(ft.u), np.asarray(fu.u), atol=1e-6)
    np.testing.assert_allclose(np.asarray(ft.v), np.asarray(fu.v), atol=1e-6)
    # And it genuinely stopped early: a run at the full budget differs.
    ff = hs_solve_tiled(
        i1, i2, HSConfig(alpha=0.5, iters=256, backend="jnp"),
        mesh=mesh, halo_sweeps=s,
    )
    assert float(jnp.abs(ft.u - ff.u).max()) > 0


def test_tol_on_odd_shape_masks_pad(pair):
    """Pad garbage must not feed the stop decision: a 37x115 frame on a
    2x4 mesh pads both axes; tiled tol must still match untiled tol."""
    i1, i2, _ = translation_pair(37, 115, 1.0, 0.0, key=7)
    i1, i2 = jnp.asarray(i1), jnp.asarray(i2)
    mesh = make_mesh(MeshConfig(batch=1, y=2, x=4))
    cfg = HSConfig(alpha=0.5, iters=128, tol=5e-4, block_sweeps=2,
                   backend="jnp")
    ft = hs_solve_tiled(i1, i2, cfg, mesh=mesh, halo_sweeps=2)
    fu = hs_solve(i1, i2, cfg)
    np.testing.assert_allclose(np.asarray(ft.u), np.asarray(fu.u), atol=1e-6)
    np.testing.assert_allclose(np.asarray(ft.v), np.asarray(fu.v), atol=1e-6)


def test_tol_sor_tiled_runs(pair):
    i1, i2 = pair
    mesh = make_mesh(MeshConfig(batch=1, y=2, x=2))
    cfg = HSConfig(alpha=0.5, iters=64, tol=1e-4, solver="sor", omega=1.5,
                   backend="jnp")
    f = hs_solve_tiled(i1, i2, cfg, mesh=mesh)
    assert np.isfinite(np.asarray(f.u)).all()
    assert float(jnp.abs(f.u).max()) > 0


def test_tol_batched_global_stop(pair):
    i1, i2 = pair
    b1 = jnp.stack([i1, i1 * 0.5])
    b2 = jnp.stack([i2, i2 * 0.5])
    mesh = make_mesh(MeshConfig(batch=2, y=2, x=1))
    cfg = HSConfig(alpha=0.5, iters=128, tol=1e-4, backend="jnp")
    f = hs_solve_tiled(b1, b2, cfg, mesh=mesh, halo_sweeps=2)
    assert f.u.shape == b1.shape
    assert np.isfinite(np.asarray(f.u)).all()


def test_pyramid_tiled_tol_matches_untiled(pair):
    """tol flows through the sharded pyramid per level: matched cadences
    (halo_sweeps == block_sweeps) give identical stopping blocks, so the
    tiled pyramid == untiled pyramid to float tolerance."""
    from hsflow.config import PyramidConfig
    from hsflow.dist import hs_pyramid_tiled
    from hsflow.pyramid import hs_pyramid

    i1, i2, _ = translation_pair(64, 96, 3.0, 0.0, key=9)
    i1, i2 = jnp.asarray(i1), jnp.asarray(i2)
    mesh = make_mesh(MeshConfig(batch=1, y=2, x=2))
    pyr = PyramidConfig(levels=3)
    cfg = HSConfig(alpha=0.5, iters=128, tol=1e-2, block_sweeps=2,
                   backend="jnp")
    ft = hs_pyramid_tiled(i1, i2, cfg, pyr, mesh=mesh, halo_sweeps=2)
    fu = hs_pyramid(i1, i2, cfg, pyr)
    np.testing.assert_allclose(np.asarray(ft.u), np.asarray(fu.u), atol=2e-6)
    np.testing.assert_allclose(np.asarray(ft.v), np.asarray(fu.v), atol=2e-6)


def test_tol_budget_below_block_shrinks_gracefully(pair):
    """iters < halo_sweeps: the check block shrinks to the budget instead
    of erroring (matters for coarse pyramid levels with small budgets)."""
    i1, i2 = pair
    mesh = make_mesh(MeshConfig(batch=1, y=2, x=1))
    cfg_t = HSConfig(alpha=0.5, iters=3, tol=1e-30, backend="jnp")
    cfg_f = HSConfig(alpha=0.5, iters=3, backend="jnp")
    ft = hs_solve_tiled(i1, i2, cfg_t, mesh=mesh, halo_sweeps=5)
    ff = hs_solve_tiled(i1, i2, cfg_f, mesh=mesh, halo_sweeps=5)
    assert float(jnp.abs(ft.u - ff.u).max()) == 0.0
