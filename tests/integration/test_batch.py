"""Batched/DP solve (SURVEY.md §4: batched vmap == loop of singles; §2b P1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from hsflow.batch import hs_solve_batched, video_pairs
from hsflow.config import HSConfig, PyramidConfig
from hsflow.data.synthetic import synthetic_sequence
from hsflow.solver import hs_solve


@pytest.fixture(scope="module")
def video():
    frames, gt = synthetic_sequence(5, 40, 48, tx=1.0, ty=0.0, key=17)
    return jnp.asarray(frames), gt


def test_batched_equals_loop_of_singles(video):
    frames, _ = video
    i1, i2 = video_pairs(frames)
    cfg = HSConfig(alpha=0.5, iters=60, backend="jnp")
    batched = hs_solve_batched(i1, i2, cfg)
    for k in range(i1.shape[0]):
        single = hs_solve(i1[k], i2[k], cfg)
        np.testing.assert_allclose(np.asarray(batched.u[k]), np.asarray(single.u), atol=1e-5)
        np.testing.assert_allclose(np.asarray(batched.v[k]), np.asarray(single.v), atol=1e-5)


def test_batched_pyramid(video):
    frames, _ = video
    i1, i2 = video_pairs(frames)
    cfg = HSConfig(alpha=0.5, iters=30, backend="jnp")
    flow = hs_solve_batched(i1, i2, cfg, pyr=PyramidConfig(levels=2))
    assert flow.u.shape == i1.shape


def test_batched_with_mesh_sharding(video):
    frames, _ = video
    i1, i2 = video_pairs(frames)  # B=4
    devices = np.array(jax.devices()[:4]).reshape(4)
    mesh = Mesh(devices, ("batch",))
    cfg = HSConfig(alpha=0.5, iters=60, backend="jnp")
    sharded = hs_solve_batched(i1, i2, cfg, mesh=mesh)
    plain = hs_solve_batched(i1, i2, cfg)
    np.testing.assert_allclose(np.asarray(sharded.u), np.asarray(plain.u), atol=1e-5)


def test_video_pairs_shapes(video):
    frames, _ = video
    i1, i2 = video_pairs(frames)
    assert i1.shape == i2.shape == (4, 40, 48)
    np.testing.assert_array_equal(np.asarray(i1[1]), np.asarray(i2[0]))


def test_video_pairs_rejects_2d():
    with pytest.raises(ValueError):
        video_pairs(jnp.zeros((8, 8)))


def test_batched_rejects_2d():
    with pytest.raises(ValueError):
        hs_solve_batched(jnp.zeros((8, 8)), jnp.zeros((8, 8)))


def test_batched_pyramid_pallas_matches_jnp(kernel_mode):
    """Batched pyramid on the pallas backend (one batch-axis kernel solve
    per level) == jnp backend."""
    import numpy as np
    import jax.numpy as jnp
    from hsflow.batch import hs_solve_batched
    from hsflow.config import HSConfig, PyramidConfig

    rng = np.random.default_rng(9)
    i1 = jnp.asarray(rng.uniform(0, 1, (2, 32, 48)).astype(np.float32))
    i2 = jnp.asarray(rng.uniform(0, 1, (2, 32, 48)).astype(np.float32))
    pyr = PyramidConfig(levels=2)
    fp = hs_solve_batched(i1, i2, HSConfig(alpha=0.5, iters=8, backend="pallas"), pyr)
    fj = hs_solve_batched(i1, i2, HSConfig(alpha=0.5, iters=8, backend="jnp"), pyr)
    np.testing.assert_allclose(np.asarray(fp.u), np.asarray(fj.u), atol=2e-6)
