"""bfloat16 compute path (HSConfig.dtype) — the production serving dtype.

bf16 halves the bytes a sweep moves; accuracy on flow fields degrades
gracefully (flow magnitudes are O(px)). Kernel-vs-jnp equivalence holds to
bf16 rounding at matching dtype; flow quality vs fp32 stays within a loose
bound on synthetic GT.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from hsflow.config import HSConfig
from hsflow.data.synthetic import translation_pair
from hsflow.kernels import jacobi as jk
from hsflow.ops import stencils
from hsflow.solver import hs_solve, precompute


def test_bf16_solver_runs_and_tracks_fp32():
    i1, i2, gt = translation_pair(64, 96, 1.0, 0.0, key=13)
    f32 = hs_solve(jnp.asarray(i1), jnp.asarray(i2), HSConfig(alpha=0.2, iters=300))
    f16 = hs_solve(
        jnp.asarray(i1), jnp.asarray(i2),
        HSConfig(alpha=0.2, iters=300, dtype="bfloat16"),
    )
    assert f16.u.dtype == jnp.bfloat16
    du = np.abs(np.asarray(f16.u, np.float32) - np.asarray(f32.u))[8:-8, 8:-8]
    assert float(du.mean()) < 0.1, float(du.mean())


def test_bf16_kernel_matches_bf16_jnp():
    rng = np.random.default_rng(0)
    i1 = jnp.asarray(rng.uniform(0, 1, (32, 144)).astype(np.float32))
    i2 = jnp.asarray(rng.uniform(0, 1, (32, 144)).astype(np.float32))
    cfg = HSConfig(alpha=0.7, dtype="bfloat16")
    ex, ey, et, invd = precompute(i1, i2, cfg)
    u = jnp.zeros_like(ex)
    v = jnp.zeros_like(ex)
    uo, vo = jk.jacobi_sweeps(u, v, ex, ey, et, invd, 5, interpret=True)
    ur, vr = u, v
    for _ in range(5):
        ur, vr = stencils.jacobi_step(ur, vr, ex, ey, et, invd)
    np.testing.assert_allclose(
        np.asarray(uo, np.float32), np.asarray(ur, np.float32), atol=1e-2
    )
    assert uo.dtype == jnp.bfloat16
