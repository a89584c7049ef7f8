"""Rung 3 of the oracle chain (SURVEY.md §4): jnp ops == golden NumPy <= 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest

from hsflow.ops import golden, stencils


@pytest.fixture(scope="module")
def random_images():
    rng = np.random.default_rng(42)
    i1 = rng.uniform(0.0, 1.0, (33, 47)).astype(np.float32)  # odd, unaligned
    i2 = rng.uniform(0.0, 1.0, (33, 47)).astype(np.float32)
    return i1, i2


@pytest.mark.parametrize("variant", ["hs_cube", "central"])
def test_derivatives_match_golden(random_images, variant):
    i1, i2 = random_images
    gx, gy, gt = golden.derivatives_numpy(i1, i2, variant)
    jx, jy, jt = stencils.derivatives(jnp.asarray(i1), jnp.asarray(i2), variant)
    np.testing.assert_allclose(np.asarray(jx), gx, atol=1e-5)
    np.testing.assert_allclose(np.asarray(jy), gy, atol=1e-5)
    np.testing.assert_allclose(np.asarray(jt), gt, atol=1e-5)


def test_neighbor_avg_matches_golden(random_images):
    u = random_images[0]
    np.testing.assert_allclose(
        np.asarray(stencils.neighbor_avg(jnp.asarray(u))),
        golden.neighbor_avg_numpy(u),
        atol=1e-5,
    )


def test_jacobi_step_matches_golden(random_images):
    i1, i2 = random_images
    alpha = 0.7
    ex, ey, et = golden.derivatives_numpy(i1, i2)
    rng = np.random.default_rng(1)
    u = rng.normal(size=i1.shape)
    v = rng.normal(size=i1.shape)
    gu, gv = golden.jacobi_step_numpy(u, v, ex, ey, et, alpha)

    inv_den = 1.0 / (alpha * alpha + ex * ex + ey * ey)
    ju, jv = stencils.jacobi_step(
        jnp.asarray(u, jnp.float32),
        jnp.asarray(v, jnp.float32),
        jnp.asarray(ex, jnp.float32),
        jnp.asarray(ey, jnp.float32),
        jnp.asarray(et, jnp.float32),
        jnp.asarray(inv_den, jnp.float32),
    )
    np.testing.assert_allclose(np.asarray(ju), gu, atol=1e-5)
    np.testing.assert_allclose(np.asarray(jv), gv, atol=1e-5)


def test_stencils_support_batch_axes(random_images):
    i1, i2 = random_images
    b1 = jnp.stack([jnp.asarray(i1)] * 3)
    avg_b = stencils.neighbor_avg(b1)
    avg_s = stencils.neighbor_avg(jnp.asarray(i1))
    for k in range(3):
        np.testing.assert_allclose(np.asarray(avg_b[k]), np.asarray(avg_s), atol=0)
