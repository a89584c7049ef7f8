"""sqrt(n)-checkpointed relaxation loop (stencils.checkpointed_loop).

Rungs: (1) forward EXACTLY equals the plain fori_loop at many n (block +
remainder partitions must not change the sweep sequence); (2) gradients
through hs_solve equal a plain-loop reference on both backends; (3) the
scan structure actually engages (n_blocks >= 2) for production n.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hsflow.config import HSConfig
from hsflow.ops import stencils
from hsflow.solver import hs_solve, precompute


def _problem(h=24, w=32, seed=0):
    rng = np.random.default_rng(seed)
    i1 = jnp.asarray(rng.uniform(0, 1, (h, w)).astype(np.float32))
    i2 = jnp.asarray(rng.uniform(0, 1, (h, w)).astype(np.float32))
    return i1, i2


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 9, 10, 17, 25, 100])
def test_forward_identical_to_plain_loop(n):
    i1, i2 = _problem()
    ex, ey, et, invd = precompute(i1, i2, HSConfig(alpha=0.5))
    u = jnp.zeros_like(ex)
    v = jnp.zeros_like(ex)
    step = lambda uv: stencils.jacobi_step(uv[0], uv[1], ex, ey, et, invd)
    uc, vc = stencils.checkpointed_loop(step, (u, v), n)
    up, vp = jax.lax.fori_loop(0, n, lambda _, x: step(x), (u, v))
    assert float(jnp.abs(uc - up).max()) == 0.0
    assert float(jnp.abs(vc - vp).max()) == 0.0


@pytest.mark.parametrize("backend,solver", [
    ("jnp", "jacobi"), ("pallas", "jacobi"),
    ("jnp", "sor"), ("pallas", "sor"),
])
def test_grads_match_plain_loop_reference(backend, solver, kernel_mode):
    """d(sum of flow)/d(frame2) through the checkpointed solve == through a
    hand-rolled plain fori_loop of the same steps."""
    i1, i2 = _problem(seed=3)
    n = 23  # exercises blocks of 4 + remainder 3
    cfg = HSConfig(alpha=0.5, iters=n, solver=solver, omega=1.5,
                   backend=backend)

    def loss(b):
        f = hs_solve(i1, b, cfg)
        return jnp.sum(f.u) + 0.5 * jnp.sum(f.v)

    def loss_plain(b):
        ex, ey, et, invd = precompute(i1, b, cfg)
        u = jnp.zeros_like(ex)
        v = jnp.zeros_like(ex)
        if solver == "sor":
            colors = stencils.color_masks(*u.shape)
            step = lambda uv: stencils.sor_step(
                uv[0], uv[1], ex, ey, et, invd, cfg.omega, colors)
        else:
            step = lambda uv: stencils.jacobi_step(
                uv[0], uv[1], ex, ey, et, invd)
        u, v = jax.lax.fori_loop(0, n, lambda _, x: step(x), (u, v))
        return jnp.sum(u) + 0.5 * jnp.sum(v)

    g = jax.grad(loss)(i2)
    gr = jax.grad(loss_plain)(i2)
    np.testing.assert_allclose(np.asarray(g), np.asarray(gr),
                               atol=2e-5, rtol=1e-4)


def test_remat_structure_engages():
    """At n=100 the loop must be a scan of 10 checkpointed 10-sweep blocks
    (not a fallthrough) — assert via the jaxpr containing a remat call."""
    i1, i2 = _problem()
    ex, ey, et, invd = precompute(i1, i2, HSConfig(alpha=0.5))
    u = jnp.zeros_like(ex)
    step = lambda uv: stencils.jacobi_step(uv[0], uv[1], ex, ey, et, invd)
    jaxpr = jax.make_jaxpr(
        lambda a, b: stencils.checkpointed_loop(step, (a, b), 100)
    )(u, u)
    assert "remat" in str(jaxpr)
