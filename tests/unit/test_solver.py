"""Solver core vs golden (oracle chain rung 3; SURVEY.md §4)."""

import jax.numpy as jnp
import numpy as np
import pytest

from hsflow.config import HSConfig
from hsflow.ops import golden
from hsflow.solver import Flow, hs_solve


@pytest.fixture(scope="module")
def images(small_translation_pair):
    i1, i2, _ = small_translation_pair
    return i1, i2


@pytest.mark.parametrize("variant", ["hs_cube", "central"])
def test_solver_matches_golden(images, variant):
    i1, i2 = images
    cfg = HSConfig(alpha=1.0, iters=30, backend="jnp", deriv_variant=variant)
    flow = hs_solve(jnp.asarray(i1), jnp.asarray(i2), cfg)
    gu, gv = golden.hs_numpy(i1, i2, alpha=1.0, iters=30, deriv_variant=variant)
    np.testing.assert_allclose(np.asarray(flow.u), gu, atol=2e-5)
    np.testing.assert_allclose(np.asarray(flow.v), gv, atol=2e-5)


def test_zero_iters_returns_zero_flow(images):
    i1, i2 = images
    flow = hs_solve(jnp.asarray(i1), jnp.asarray(i2), HSConfig(iters=0, backend="jnp"))
    assert float(jnp.abs(flow.u).max()) == 0.0
    assert float(jnp.abs(flow.v).max()) == 0.0


def test_warm_start_equals_split_run(images):
    """iters=40 in one go == iters=25 then warm-start 15 (same Jacobi chain)."""
    i1, i2 = (jnp.asarray(a) for a in images)
    full = hs_solve(i1, i2, HSConfig(iters=40, backend="jnp"))
    part = hs_solve(i1, i2, HSConfig(iters=25, backend="jnp"))
    resumed = hs_solve(i1, i2, HSConfig(iters=15, backend="jnp"), init=part)
    np.testing.assert_allclose(np.asarray(resumed.u), np.asarray(full.u), atol=1e-6)
    np.testing.assert_allclose(np.asarray(resumed.v), np.asarray(full.v), atol=1e-6)


def test_shape_mismatch_raises(images):
    i1, _ = images
    with pytest.raises(ValueError):
        hs_solve(jnp.asarray(i1), jnp.asarray(i1)[:-1])


def test_batch_input_raises(images):
    i1, i2 = images
    with pytest.raises(ValueError):
        hs_solve(jnp.asarray(i1)[None], jnp.asarray(i2)[None])


def test_flow_is_pytree(images):
    import jax

    i1, i2 = (jnp.asarray(a) for a in images)
    flow = hs_solve(i1, i2, HSConfig(iters=5, backend="jnp"))
    leaves = jax.tree_util.tree_leaves(flow)
    assert len(leaves) == 2
    assert isinstance(flow, Flow)
