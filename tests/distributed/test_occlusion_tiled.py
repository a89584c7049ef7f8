"""Mesh-sharded bidirectional occlusion solves (VERDICT r2 items 8/9).

`consistency.flow_with_occlusion(mesh=...)` shards the batch-2 forward+
backward HS solve over the FULL ("batch","y","x") mesh via the tiled
pyramid; tiled == untiled masks by Jacobi order-independence. The LK leg
routes through lk_solve_tiled per direction.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from hsflow.config import HSConfig, LKConfig, PyramidConfig
from hsflow.consistency import flow_with_occlusion, solve_bidirectional
from hsflow.data.synthetic import translation_pair


def _mesh(batch, y, x):
    devs = np.array(jax.devices()[: batch * y * x]).reshape(batch, y, x)
    return Mesh(devs, ("batch", "y", "x"))


@pytest.mark.parametrize("shape", [(1, 2, 4), (2, 2, 2), (1, 1, 8)])
def test_hs_occlusion_tiled_matches_untiled(shape):
    i1, i2, _ = translation_pair(64, 96, 1.0, 0.5, key=4)
    i1, i2 = jnp.asarray(i1), jnp.asarray(i2)
    cfg = HSConfig(alpha=0.5, iters=40, backend="jnp")
    f_ref, m_ref = flow_with_occlusion(i1, i2, cfg)
    f_out, m_out = flow_with_occlusion(i1, i2, cfg, mesh=_mesh(*shape),
                                       halo_sweeps=2)
    assert float(jnp.abs(f_out.u - f_ref.u).max()) <= 2e-5
    assert float(jnp.abs(f_out.v - f_ref.v).max()) <= 2e-5
    assert float(jnp.mean(m_out != m_ref)) <= 1e-3


def test_hs_occlusion_tiled_pyramid_odd_shape():
    i1, i2, _ = translation_pair(67, 93, 1.5, 0.0, key=6)
    i1, i2 = jnp.asarray(i1), jnp.asarray(i2)
    cfg = HSConfig(alpha=0.5, iters=30, backend="jnp")
    pyr = PyramidConfig(levels=2)
    f_ref, m_ref = flow_with_occlusion(i1, i2, cfg, pyr)
    f_out, m_out = flow_with_occlusion(i1, i2, cfg, pyr, mesh=_mesh(1, 2, 4))
    assert float(jnp.abs(f_out.u - f_ref.u).max()) <= 2e-5
    assert float(jnp.mean(m_out != m_ref)) <= 1e-3


def test_lk_bidirectional_tiled_matches_untiled():
    i1, i2, _ = translation_pair(64, 96, 1.0, 0.0, key=7)
    i1, i2 = jnp.asarray(i1), jnp.asarray(i2)
    cfg = LKConfig(window=9, iters=2)
    fwd_r, bwd_r = solve_bidirectional(i1, i2, lk=cfg)
    fwd_t, bwd_t = solve_bidirectional(i1, i2, lk=cfg, mesh=_mesh(1, 2, 4))
    assert float(jnp.abs(fwd_t.u - fwd_r.u).max()) <= 2e-5
    assert float(jnp.abs(bwd_t.u - bwd_r.u).max()) <= 2e-5
