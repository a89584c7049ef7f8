"""Mesh-sharded TV-L1 (tvl1.tvl1_solve_tiled) — tiled == untiled.

Like lk_solve_tiled (test_lk_tiled.py), the solver distributes as GLOBAL
jit ops under with_sharding_constraint, so the arithmetic is byte-identical
to the untiled path and GSPMD inserts the 1-px halo collectives for the
shift/median/warp ops itself. Exercised at multiple mesh shapes including
odd/unaligned frame sizes, plus batched-over-mesh and the mesh-sharded
bidirectional occlusion solve.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from hsflow import PyramidConfig, TVL1Config, tvl1_solve, tvl1_solve_batched
from hsflow.data.synthetic import translation_pair, two_motion_pair
from hsflow.tvl1 import tvl1_solve_tiled

TOL = 2e-5  # float reassociation across GSPMD partitions


def _mesh(y, x, batch=1):
    devs = np.array(jax.devices()[: batch * y * x]).reshape(batch, y, x)
    return Mesh(devs, ("batch", "y", "x"))


@pytest.mark.parametrize("my,mx", [(2, 4), (8, 1), (1, 8), (2, 2)])
def test_tiled_matches_untiled(my, mx):
    i1, i2, _ = two_motion_pair(64, 96, (1.0, 0.0), (-1.0, 0.0), key=3)
    i1, i2 = jnp.asarray(i1), jnp.asarray(i2)
    cfg = TVL1Config(warps=2, iters=15)
    ref = tvl1_solve(i1, i2, cfg)
    out = tvl1_solve_tiled(i1, i2, cfg, mesh=_mesh(my, mx))
    assert float(jnp.abs(out.u - ref.u).max()) <= TOL
    assert float(jnp.abs(out.v - ref.v).max()) <= TOL


def test_odd_unaligned_shape_and_pyramid():
    """67x93 doesn't divide any mesh axis; 2 levels add odd pyramid shapes."""
    i1, i2, _ = two_motion_pair(67, 93, (0.7, 0.0), (-0.5, 0.3), key=5)
    i1, i2 = jnp.asarray(i1), jnp.asarray(i2)
    cfg = TVL1Config(warps=2, iters=10)
    pyr = PyramidConfig(levels=2)
    ref = tvl1_solve(i1, i2, cfg, pyr)
    out = tvl1_solve_tiled(i1, i2, cfg, pyr, mesh=_mesh(2, 4))
    assert float(jnp.abs(out.u - ref.u).max()) <= TOL
    assert float(jnp.abs(out.v - ref.v).max()) <= TOL


def test_batched_over_mesh_matches_singles():
    pairs = [translation_pair(48, 64, d, 0.2, key=k) for k, d in
             enumerate((0.5, -0.5, 1.0, 0.0))]
    i1 = jnp.stack([jnp.asarray(p[0]) for p in pairs])
    i2 = jnp.stack([jnp.asarray(p[1]) for p in pairs])
    cfg = TVL1Config(warps=1, iters=10)
    mesh = _mesh(1, 2, batch=4)
    fb = tvl1_solve_batched(i1, i2, cfg, mesh=mesh)
    for k, p in enumerate(pairs):
        fs = tvl1_solve(jnp.asarray(p[0]), jnp.asarray(p[1]), cfg)
        assert float(jnp.abs(fb.u[k] - fs.u).max()) <= TOL


def test_bidirectional_occlusion_over_mesh():
    """consistency.flow_with_occlusion(tvl1=..., mesh=...) == untiled."""
    from hsflow.consistency import flow_with_occlusion

    i1, i2, _ = two_motion_pair(64, 96, (1.5, 0.0), (-1.5, 0.0), key=7)
    i1, i2 = jnp.asarray(i1), jnp.asarray(i2)
    cfg = TVL1Config(warps=2, iters=10)
    f_ref, m_ref = flow_with_occlusion(i1, i2, tvl1=cfg)
    f_out, m_out = flow_with_occlusion(i1, i2, tvl1=cfg, mesh=_mesh(2, 4))
    assert float(jnp.abs(f_out.u - f_ref.u).max()) <= TOL
    # masks are boolean threshold tests — bit-flips only possible exactly at
    # the threshold; none expected at these tolerances
    assert float(jnp.mean(m_out != m_ref)) <= 1e-3


def test_tiled_validation():
    a = jnp.zeros((32, 32))
    cfg = TVL1Config()
    with pytest.raises(ValueError, match="mesh"):
        tvl1_solve_tiled(a, a, cfg)
    with pytest.raises(ValueError, match="2-D"):
        tvl1_solve_tiled(jnp.zeros((2, 32, 32)), jnp.zeros((2, 32, 32)), cfg,
                         mesh=_mesh(2, 4))
