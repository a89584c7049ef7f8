"""Auto-tuned SOR omega (solver.tune_omega; cfg.omega == 0 sentinel).

The estimate power-iterates the homogeneous Jacobi operator for rho and
applies omega* = 2/(1+sqrt(1-rho^2)). Measured bands (see tune_omega
docstring): data-dominated alpha=0.1 problems tune to ~1.5 (14x lower EPE
at 60 sweeps than the 1.9 default); smoothness-dominated alpha=1 tunes
to ~1.8+.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from hsflow.config import HSConfig
from hsflow.data.synthetic import translation_pair
from hsflow.metrics import epe, interior
from hsflow.solver import hs_solve, tune_omega


@pytest.fixture(scope="module")
def pair():
    i1, i2, gt = translation_pair(64, 96, 1.0, 0.0, key=5)
    return jnp.asarray(i1), jnp.asarray(i2), gt


def test_omega_bands(pair):
    i1, i2, _ = pair
    om_small = tune_omega(i1, i2, HSConfig(alpha=0.1))
    om_big = tune_omega(i1, i2, HSConfig(alpha=1.0))
    assert 1.35 <= om_small <= 1.7
    assert 1.7 <= om_big <= 1.95
    assert om_big > om_small  # stiffer problem -> more over-relaxation


def test_auto_beats_default_at_small_alpha(pair):
    i1, i2, gt = pair
    gtc = interior(gt, 8)

    def run(om):
        f = hs_solve(i1, i2, HSConfig(alpha=0.1, iters=60, solver="sor",
                                      omega=om, backend="jnp"))
        fl = np.stack([np.asarray(f.u), np.asarray(f.v)], -1)
        return epe(interior(fl, 8), gtc)

    e_auto = run(0.0)       # sentinel -> tuned in hs_solve
    e_default = run(1.9)
    assert e_auto < e_default / 2


def test_sentinel_equals_explicit(pair):
    i1, i2, _ = pair
    cfg0 = HSConfig(alpha=0.1, iters=20, solver="sor", omega=0.0,
                    backend="jnp")
    om = tune_omega(i1, i2, cfg0)
    fa = hs_solve(i1, i2, cfg0)
    fe = hs_solve(i1, i2, HSConfig(alpha=0.1, iters=20, solver="sor",
                                   omega=om, backend="jnp"))
    assert float(jnp.abs(fa.u - fe.u).max()) == 0.0


def test_pyramid_tiled_resolves_sentinel(pair):
    """Regression: the tiled pyramid (CLI --mesh route) must tune, not run
    identity sweeps (omega=0 in the SOR update u + omega*(un-u) is a
    no-op that silently returned zero flow)."""
    from hsflow.config import MeshConfig, PyramidConfig
    from hsflow.dist import hs_pyramid_tiled, make_mesh

    i1, i2, _ = pair
    mesh = make_mesh(MeshConfig(batch=1, y=2, x=2))
    cfg = HSConfig(alpha=0.1, iters=30, solver="sor", omega=0.0,
                   backend="jnp")
    f = hs_pyramid_tiled(i1, i2, cfg, PyramidConfig(levels=1), mesh=mesh)
    assert float(jnp.abs(f.u).max()) > 0.1
    # Batched stacks cannot tune on one pair: reject.
    with pytest.raises(ValueError, match="single-pair"):
        hs_pyramid_tiled(jnp.stack([i1, i1]), jnp.stack([i2, i2]), cfg,
                         PyramidConfig(levels=1), mesh=mesh)


def test_bidirectional_resolves_sentinel(pair):
    from hsflow.consistency import solve_bidirectional

    i1, i2, _ = pair
    cfg = HSConfig(alpha=0.1, iters=30, solver="sor", omega=0.0,
                   backend="jnp")
    fwd, bwd = solve_bidirectional(i1, i2, cfg)
    assert float(jnp.abs(fwd.u).max()) > 0.1
    assert float(jnp.abs(bwd.u).max()) > 0.1


def test_guards(pair):
    i1, i2, _ = pair
    from hsflow.batch import hs_solve_batched

    with pytest.raises(ValueError, match="omega"):
        HSConfig(omega=-0.5)
    with pytest.raises(ValueError, match="auto"):
        hs_solve_batched(jnp.stack([i1]), jnp.stack([i2]),
                         HSConfig(solver="sor", omega=0.0))
    from hsflow.config import MeshConfig
    from hsflow.dist import hs_solve_tiled, make_mesh

    mesh = make_mesh(MeshConfig(batch=1, y=2, x=1))
    with pytest.raises(ValueError, match="auto"):
        hs_solve_tiled(i1, i2, HSConfig(solver="sor", omega=0.0), mesh=mesh)
