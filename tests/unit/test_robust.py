"""Charbonnier robust-penalty HS (robust.py, HSConfig(solver="robust")).

Oracle chain (SURVEY.md §4): the two_motion_pair generator provides
analytic GT with a hard motion discontinuity — the exact failure mode of
quadratic HS smoothness the robust solver exists to fix. Claims tested are
the measured ones in robust.py's docstring.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hsflow import HSConfig, hs_solve
from hsflow.data.synthetic import translation_pair, two_motion_pair
from hsflow.metrics import epe, interior


def _epe(f, gt, crop=8):
    fl = np.stack([np.asarray(f.u), np.asarray(f.v)], -1)
    return float(epe(interior(fl, crop), interior(gt, crop)))


@pytest.fixture(scope="module")
def seam_case():
    i1, i2, gt = two_motion_pair(96, 128, (1.0, 0.0), (-1.0, 0.0), key=3)
    return jnp.asarray(i1), jnp.asarray(i2), gt


def test_two_motion_pair_is_piecewise():
    i1, i2, gt = two_motion_pair(32, 48, (1.0, 0.0), (0.0, 1.0), key=1)
    assert i1.shape == (32, 48) and gt.shape == (32, 48, 2)
    assert (gt[:, :24] == np.array([1.0, 0.0], np.float32)).all()
    assert (gt[:, 24:] == np.array([0.0, 1.0], np.float32)).all()
    assert np.isfinite(i1).all() and np.isfinite(i2).all()


def test_robust_beats_classic_at_discontinuity(seam_case):
    """Measured: classic 0.037, robust 0.017-0.024 at the same budget."""
    i1, i2, gt = seam_case
    fc = hs_solve(i1, i2, HSConfig(alpha=0.1, iters=400))
    fr = hs_solve(i1, i2, HSConfig(alpha=0.1, iters=400, solver="robust"))
    ec, er = _epe(fc, gt), _epe(fr, gt)
    assert er < 0.75 * ec, (er, ec)


def test_seam_band_sharper(seam_case):
    """Measured: seam-band EPE halves (0.32 -> 0.16)."""
    i1, i2, gt = seam_case
    band = np.zeros((96, 128), bool)
    band[8:-8, 64 - 6 : 64 + 6] = True
    fc = hs_solve(i1, i2, HSConfig(alpha=0.1, iters=400))
    fr = hs_solve(i1, i2, HSConfig(alpha=0.1, iters=400, solver="robust",
                                   robust_eps_s=0.01))

    def band_epe(f):
        fl = np.stack([np.asarray(f.u), np.asarray(f.v)], -1)
        return float(np.sqrt(((fl - gt) ** 2).sum(-1))[band].mean())

    assert band_epe(fr) < 0.65 * band_epe(fc)


def test_smooth_case_parity():
    """On smooth motion the weights sit near the unit plateau: robust must
    be at least as accurate as classic (measured 0.021 vs 0.025)."""
    i1, i2, gt = translation_pair(96, 128, 1.0, 0.5, key=5)
    i1, i2 = jnp.asarray(i1), jnp.asarray(i2)
    fc = hs_solve(i1, i2, HSConfig(alpha=0.1, iters=400))
    fr = hs_solve(i1, i2, HSConfig(alpha=0.1, iters=400, solver="robust"))
    assert _epe(fr, gt, 10) < 1.2 * _epe(fc, gt, 10)
    assert _epe(fr, gt, 10) < 0.05


def test_batched_matches_singles(seam_case):
    from hsflow.batch import hs_solve_batched

    i1, i2, _ = seam_case
    cfg = HSConfig(alpha=0.1, iters=40, solver="robust")
    b1 = jnp.stack([i1, i2])
    b2 = jnp.stack([i2, i1])
    fb = hs_solve_batched(b1, b2, cfg)
    f0 = hs_solve(i1, i2, cfg)
    f1 = hs_solve(i2, i1, cfg)
    assert float(jnp.abs(fb.u[0] - f0.u).max()) <= 2e-6
    assert float(jnp.abs(fb.u[1] - f1.u).max()) <= 2e-6


def test_tol_early_stop(seam_case):
    i1, i2, gt = seam_case
    cfg = HSConfig(alpha=0.1, iters=400, solver="robust", tol=1e-4,
                   block_sweeps=40)
    f = hs_solve(i1, i2, cfg)
    assert _epe(f, gt) < 0.06


def test_differentiable(seam_case):
    i1, i2, _ = seam_case

    def loss(a, b):
        f = hs_solve(a, b, HSConfig(alpha=0.2, iters=30, solver="robust"))
        return jnp.mean(f.u * f.u + f.v * f.v)

    g = jax.grad(loss)(i1, i2)
    assert np.isfinite(np.asarray(g)).all()
    assert float(jnp.abs(g).max()) > 0


def test_pyramid_integration(seam_case):
    from hsflow import PyramidConfig, hs_pyramid

    i1, i2, gt = seam_case
    f = hs_pyramid(i1, i2, HSConfig(alpha=0.1, iters=120, solver="robust"),
                   PyramidConfig(levels=2))
    assert _epe(f, gt) < 0.08


def test_config_validation():
    with pytest.raises(ValueError):
        HSConfig(robust_eps_d=0.0)
    with pytest.raises(ValueError):
        HSConfig(robust_eps_s=-1.0)
    with pytest.raises(ValueError):
        HSConfig(robust_update_every=0)
    with pytest.raises(ValueError):
        HSConfig(solver="tv")
