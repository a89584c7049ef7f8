"""Mesh-sharded Lucas-Kanade: tiled == untiled at several mesh shapes.

LK distributes as global jit ops under with_sharding_constraint (GSPMD
inserts the stencil/window halo collectives itself — lucas_kanade.py::
lk_solve_tiled), so the invariant is float-tolerance equality against the
single-device path, the same contract as tests/distributed/test_pyramid_tiled.
Runs on the 8-fake-device CPU backend (tests/conftest.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from hsflow import LKConfig, PyramidConfig
from hsflow.data.synthetic import translation_pair
from hsflow.lucas_kanade import lk_solve, lk_solve_tiled

TOL = 2e-5


def _mesh(y, x):
    devs = np.array(jax.devices()[: y * x]).reshape(y, x)
    return Mesh(devs, ("y", "x"))


@pytest.mark.parametrize("my,mx", [(1, 1), (2, 4), (8, 1), (1, 8)])
def test_tiled_matches_untiled(my, mx):
    i1, i2, _ = translation_pair(96, 128, 1.0, 0.5, key=3)
    i1, i2 = jnp.asarray(i1), jnp.asarray(i2)
    cfg = LKConfig(window=11, iters=2)
    pyr = PyramidConfig(levels=2)
    ref = lk_solve(i1, i2, cfg, pyr)
    out = lk_solve_tiled(i1, i2, cfg, pyr, mesh=_mesh(my, mx))
    assert float(jnp.abs(out.u - ref.u).max()) <= TOL
    assert float(jnp.abs(out.v - ref.v).max()) <= TOL


def test_odd_shape():
    # tile-unaligned: GSPMD handles uneven shard geometry itself
    i1, i2, _ = translation_pair(67, 93, 0.7, -0.3, key=5)
    i1, i2 = jnp.asarray(i1), jnp.asarray(i2)
    cfg = LKConfig(window=9, iters=2)
    pyr = PyramidConfig(levels=1, iters_per_level=())
    ref = lk_solve(i1, i2, cfg, pyr)
    out = lk_solve_tiled(i1, i2, cfg, pyr, mesh=_mesh(2, 4))
    assert float(jnp.abs(out.u - ref.u).max()) <= TOL
    assert float(jnp.abs(out.v - ref.v).max()) <= TOL


def test_validation():
    a = jnp.zeros((32, 32))
    with pytest.raises(ValueError, match="mesh"):
        lk_solve_tiled(a, a)
    with pytest.raises(ValueError, match="2-D"):
        lk_solve_tiled(jnp.zeros((2, 32, 32)), jnp.zeros((2, 32, 32)),
                       mesh=_mesh(1, 1))
