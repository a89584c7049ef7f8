"""Mesh-sharded robust solver: tiled == untiled (GSPMD route, as multigrid).

Runs on the 8-fake-device CPU backend (tests/conftest.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from hsflow import HSConfig, hs_solve
from hsflow.data.synthetic import two_motion_pair
from hsflow.dist import hs_solve_tiled

TOL = 2e-6


def _mesh(y, x):
    devs = np.array(jax.devices()[: y * x]).reshape(1, y, x)
    from jax.sharding import Mesh

    return Mesh(devs, ("batch", "y", "x"))


@pytest.mark.parametrize("my,mx", [(2, 4), (8, 1)])
def test_tiled_matches_untiled(my, mx):
    i1, i2, _ = two_motion_pair(64, 96, (1.0, 0.0), (-1.0, 0.0), key=3)
    i1, i2 = jnp.asarray(i1), jnp.asarray(i2)
    cfg = HSConfig(alpha=0.2, iters=50, solver="robust", backend="jnp")
    ref = hs_solve(i1, i2, cfg)
    out = hs_solve_tiled(i1, i2, cfg, mesh=_mesh(my, mx))
    assert float(jnp.abs(out.u - ref.u).max()) <= TOL
    assert float(jnp.abs(out.v - ref.v).max()) <= TOL


def test_odd_shape_and_tol():
    i1, i2, _ = two_motion_pair(67, 93, (0.7, 0.0), (-0.5, 0.3), key=5)
    i1, i2 = jnp.asarray(i1), jnp.asarray(i2)
    cfg = HSConfig(alpha=0.2, iters=60, solver="robust", tol=1e-4,
                   block_sweeps=20, backend="jnp")
    ref = hs_solve(i1, i2, cfg)
    out = hs_solve_tiled(i1, i2, cfg, mesh=_mesh(2, 4))
    assert float(jnp.abs(out.u - ref.u).max()) <= TOL


@pytest.mark.parametrize("solver", ["robust", "multigrid"])
def test_batched_gspmd_matches_per_image(solver):
    """(B, H, W) stacks on a ("batch", "y", "x") mesh: each element equals
    its single-pair untiled solve (DP x TP composition for the GSPMD-routed
    solver families)."""
    a1, a2, _ = two_motion_pair(64, 96, (1.0, 0.0), (-1.0, 0.0), key=3)
    b1, b2, _ = two_motion_pair(64, 96, (0.0, 0.8), (0.5, -0.5), key=7)
    i1 = jnp.stack([jnp.asarray(a1), jnp.asarray(b1)])
    i2 = jnp.stack([jnp.asarray(a2), jnp.asarray(b2)])
    iters = 8 if solver == "multigrid" else 40
    cfg = HSConfig(alpha=0.3, iters=iters, solver=solver, backend="jnp")
    devs = np.array(jax.devices()).reshape(2, 2, 2)
    mesh = Mesh(devs, ("batch", "y", "x"))
    out = hs_solve_tiled(i1, i2, cfg, mesh=mesh)
    assert out.u.shape == i1.shape
    for k in range(2):
        ref = hs_solve(i1[k], i2[k], cfg)
        assert float(jnp.abs(out.u[k] - ref.u).max()) <= TOL
        assert float(jnp.abs(out.v[k] - ref.v).max()) <= TOL
