"""Differentiability of the jnp solve path — a capability the OpenCL
reference cannot offer: gradients flow through the whole fixed-point solve
(lax.fori_loop with static trip count), enabling learned-prior /
photometric-loss pipelines on top of the engine."""

import jax
import pytest
import jax.numpy as jnp
import numpy as np

from hsflow.config import HSConfig
from hsflow.data.synthetic import translation_pair
from hsflow.solver import hs_solve


def test_grad_flows_through_solver():
    i1, i2, _ = translation_pair(16, 32, 1.0, 0.0, key=6)
    i1 = jnp.asarray(i1)
    i2 = jnp.asarray(i2)
    cfg = HSConfig(alpha=0.5, iters=8, backend="jnp")

    def loss(a, b):
        f = hs_solve(a, b, cfg)
        return jnp.mean(f.u**2) + jnp.mean(f.v**2)

    g1, g2 = jax.grad(loss, argnums=(0, 1))(i1, i2)
    assert g1.shape == i1.shape
    assert np.isfinite(np.asarray(g1)).all()
    assert float(jnp.abs(g1).max()) > 0  # gradient actually reaches the input
    assert np.isfinite(np.asarray(g2)).all()


def test_jvp_matches_finite_difference():
    i1, i2, _ = translation_pair(12, 24, 0.5, 0.0, key=8)
    i1 = jnp.asarray(i1)
    i2 = jnp.asarray(i2)
    cfg = HSConfig(alpha=0.8, iters=5, backend="jnp")

    def f(a):
        return jnp.sum(hs_solve(a, i2, cfg).u)

    rng = np.random.default_rng(0)
    d = jnp.asarray(rng.normal(size=i1.shape).astype(np.float32)) * 0.01
    _, jvp = jax.jvp(f, (i1,), (d,))
    eps = 1e-3
    fd = (f(i1 + eps * d) - f(i1 - eps * d)) / (2 * eps)
    # fp32 central differences carry ~1e-2 relative noise at this scale
    np.testing.assert_allclose(float(jvp), float(fd), rtol=5e-2, atol=1e-4)


def test_grad_pallas_backend_matches_jnp(kernel_mode):
    """The GPU sweep kernel carries a custom_vjp (kernel forward, jnp-twin
    VJP backward), so gradients flow through the kernel path and equal the
    jnp backend's (interpret mode on CPU; the compiled kernel on a card)."""
    i1, i2, _ = translation_pair(16, 32, 1.0, 0.0, key=6)
    i1 = jnp.asarray(i1)
    i2 = jnp.asarray(i2)

    def loss_fn(cfg):
        def loss(a, b):
            f = hs_solve(a, b, cfg)
            return jnp.mean(f.u**2) + jnp.mean(f.v**2)
        return loss

    gj1, gj2 = jax.grad(loss_fn(HSConfig(alpha=0.5, iters=8, backend="jnp")),
                        argnums=(0, 1))(i1, i2)
    gp1, gp2 = jax.grad(loss_fn(HSConfig(alpha=0.5, iters=8, backend="pallas")),
                        argnums=(0, 1))(i1, i2)
    assert float(jnp.abs(gp1).max()) > 0
    np.testing.assert_allclose(np.asarray(gp1), np.asarray(gj1), atol=1e-5)
    np.testing.assert_allclose(np.asarray(gp2), np.asarray(gj2), atol=1e-5)


def test_grad_batched_pallas_matches_jnp(kernel_mode):
    """Gradients through the batch-axis kernel == vmapped jnp."""
    from hsflow.batch import hs_solve_batched

    i1, i2, _ = translation_pair(16, 32, 1.0, 0.0, key=9)
    b1 = jnp.stack([jnp.asarray(i1)] * 2)
    b2 = jnp.stack([jnp.asarray(i2)] * 2)

    def loss_fn(cfg):
        def loss(a, b):
            f = hs_solve_batched(a, b, cfg)
            return jnp.mean(f.u**2)
        return loss

    gj = jax.grad(loss_fn(HSConfig(alpha=0.5, iters=6, backend="jnp")))(b1, b2)
    gp = jax.grad(loss_fn(HSConfig(alpha=0.5, iters=6, backend="pallas")))(b1, b2)
    assert float(jnp.abs(gp).max()) > 0
    np.testing.assert_allclose(np.asarray(gp), np.asarray(gj), atol=1e-5)


def test_grad_sor_pallas_matches_jnp(kernel_mode):
    """solver="sor" on the pallas backend runs the jnp SOR sweeps (the
    kernel is Jacobi-only): gradients equal the jnp backend's."""
    i1, i2, _ = translation_pair(16, 32, 1.0, 0.0, key=6)
    i1 = jnp.asarray(i1)
    i2 = jnp.asarray(i2)

    def loss_fn(cfg):
        def loss(a, b):
            f = hs_solve(a, b, cfg)
            return jnp.mean(f.u**2) + jnp.mean(f.v**2)
        return loss

    base = dict(alpha=0.5, iters=8, solver="sor", omega=1.6)
    gj = jax.grad(loss_fn(HSConfig(backend="jnp", **base)))(i1, i2)
    gp = jax.grad(loss_fn(HSConfig(backend="pallas", **base)))(i1, i2)
    assert float(jnp.abs(gp).max()) > 0
    np.testing.assert_allclose(np.asarray(gp), np.asarray(gj), atol=1e-5)


@pytest.mark.gpu
def test_grad_pallas_real_kernel_matches_jnp():
    """Same as above but through the compiled kernel on the card."""
    test_grad_pallas_backend_matches_jnp("gpu")
    test_grad_sor_pallas_matches_jnp("gpu")
