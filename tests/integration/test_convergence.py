"""End-to-end solver convergence on synthetic pairs (SURVEY.md §4 integration)."""

import jax.numpy as jnp
import numpy as np
import pytest

from hsflow.config import HSConfig
from hsflow.data.synthetic import WarpSpec, synthetic_pair
from hsflow.metrics import epe, interior
from hsflow.solver import hs_solve


def _flow_np(flow):
    return np.stack([np.asarray(flow.u), np.asarray(flow.v)], axis=-1)


def test_recovers_translation(small_translation_pair):
    i1, i2, gt = small_translation_pair
    cfg = HSConfig(alpha=0.1, iters=1500, backend="jnp")
    flow = hs_solve(jnp.asarray(i1), jnp.asarray(i2), cfg)
    err = epe(interior(_flow_np(flow), 8), interior(gt, 8))
    assert err < 0.08, f"interior EPE {err}"


def test_epe_improves_with_iterations(small_translation_pair):
    i1, i2, gt = small_translation_pair
    errs = []
    for iters in (50, 400, 1200):
        flow = hs_solve(
            jnp.asarray(i1), jnp.asarray(i2), HSConfig(alpha=0.5, iters=iters, backend="jnp")
        )
        errs.append(epe(interior(_flow_np(flow), 8), interior(gt, 8)))
    assert errs[0] > errs[1] > errs[2], errs


def test_small_rotation(small_translation_pair):
    i1, i2, gt = synthetic_pair(64, 64, WarpSpec.rotation(1.0), key=21)
    cfg = HSConfig(alpha=0.1, iters=1500, backend="jnp")
    flow = hs_solve(jnp.asarray(i1), jnp.asarray(i2), cfg)
    err = epe(interior(_flow_np(flow), 8), interior(gt, 8))
    assert err < 0.15, f"interior EPE {err}"


def test_alpha_smooths_flow():
    """Higher alpha => smoother (lower-variance) flow field on a noisy pair."""
    i1, i2, _ = synthetic_pair(48, 48, WarpSpec.translation(1.0, 0.0), key=4)
    rng = np.random.default_rng(0)
    i2 = np.clip(i2 + rng.normal(0, 0.02, i2.shape).astype(np.float32), 0, 1)
    var = []
    for alpha in (0.05, 1.0):
        flow = hs_solve(
            jnp.asarray(i1), jnp.asarray(i2), HSConfig(alpha=alpha, iters=300, backend="jnp")
        )
        u = interior(np.asarray(flow.u), 6)
        var.append(float(u.var()))
    assert var[1] < var[0]


def test_float64_dtype_supported():
    import jax

    if not jax.config.read("jax_enable_x64"):
        pytest.skip("x64 disabled")
    i1, i2, _ = synthetic_pair(16, 16, WarpSpec.translation(1.0, 0.0))
    hs_solve(jnp.asarray(i1), jnp.asarray(i2), HSConfig(iters=5, dtype="float64", backend="jnp"))


def test_hs_energy_monotone_decrease():
    """The Jacobi iteration minimizes the HS objective: energy must be
    non-increasing over sweeps (SURVEY.md §3.5 convergence residual)."""
    import jax.numpy as jnp

    from hsflow.config import HSConfig
    from hsflow.data.synthetic import translation_pair
    from hsflow.metrics import hs_energy
    from hsflow.solver import hs_solve

    i1, i2, _ = translation_pair(48, 64, 1.0, 0.5, key=17)
    i1 = jnp.asarray(i1)
    i2 = jnp.asarray(i2)
    alpha = 0.5
    energies = []
    for iters in (0, 5, 20, 80, 200):
        f = hs_solve(i1, i2, HSConfig(alpha=alpha, iters=iters, backend="jnp"))
        energies.append(float(hs_energy(i1, i2, f, alpha=alpha)))
    for a, b in zip(energies, energies[1:]):
        assert b <= a + 1e-7, energies
    assert energies[-1] < 0.5 * energies[0], energies
