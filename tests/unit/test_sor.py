"""4-color SOR solver (cfg.solver="sor"): oracle chain + convergence claim.

Rungs (SURVEY.md §4 style): (1) the jnp sor_step is exactly sequential
4-color Gauss-Seidel at omega=1 (validated against a literal NumPy
per-color loop); (2) the true-edge-masked twin used by the tiled solver
equals it on whole frames; (3) SOR reaches the Jacobi-N EPE in a small
fraction of N sweeps — the feature's reason to exist. SOR is plain jnp on
every backend.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from hsflow.config import HSConfig
from hsflow.metrics import epe, interior
from hsflow.ops import stencils
from hsflow.solver import hs_solve

TOL = 2e-6


def _fields(h, w, seed=0, alpha=0.5):
    rng = np.random.default_rng(seed)
    i1 = jnp.asarray(rng.uniform(0, 1, (h, w)).astype(np.float32))
    i2 = jnp.asarray(rng.uniform(0, 1, (h, w)).astype(np.float32))
    ex, ey, et = stencils.derivatives(i1, i2)
    invd = 1.0 / (alpha * alpha + ex * ex + ey * ey)
    return ex, ey, et, invd


def _numpy_gs(u, v, ex, ey, et, invd, omega, n):
    """Literal NumPy 4-color Gauss-Seidel/SOR: per color, recompute the
    neighbor average from the CURRENT field and blend that color's pixels."""
    u = np.array(u, np.float32)
    v = np.array(v, np.float32)
    ex, ey, et, invd = (np.array(a, np.float32) for a in (ex, ey, et, invd))
    h, w = u.shape
    gr, gc = np.mgrid[0:h, 0:w]
    for _ in range(n):
        for pi in (0, 1):
            for pj in (0, 1):
                cm = (gr % 2 == pi) & (gc % 2 == pj)
                ub = np.asarray(stencils.neighbor_avg(jnp.asarray(u)))
                vb = np.asarray(stencils.neighbor_avg(jnp.asarray(v)))
                frac = (ex * ub + ey * vb + et) * invd
                un = ub - ex * frac
                vn = vb - ey * frac
                u = np.where(cm, u + omega * (un - u), u)
                v = np.where(cm, v + omega * (vn - v), v)
    return u, v


@pytest.mark.parametrize("omega", [1.0, 1.7])
def test_sor_step_is_sequential_4color_gs(omega):
    ex, ey, et, invd = _fields(16, 24, seed=1)
    u0 = jnp.zeros_like(ex)
    v0 = jnp.zeros_like(ex)
    colors = stencils.color_masks(16, 24)
    u, v = u0, v0
    for _ in range(3):
        u, v = stencils.sor_step(u, v, ex, ey, et, invd, omega, colors)
    ur, vr = _numpy_gs(u0, v0, ex, ey, et, invd, omega, 3)
    assert float(jnp.abs(u - ur).max()) <= TOL
    assert float(jnp.abs(v - vr).max()) <= TOL


@pytest.mark.parametrize("shape", [(64, 80), (57, 83), (1, 9), (9, 1)])
@pytest.mark.parametrize("omega", [1.0, 1.85])
def test_masked_step_matches_unmasked_on_whole_frame(shape, omega):
    """sor_step_masked with whole-frame edge masks and global-parity colors
    == sor_step (the tiled solver's body on a 1x1 mesh)."""
    h, w = shape
    ex, ey, et, invd = _fields(h, w, seed=2)
    rng = np.random.default_rng(3)
    u0 = jnp.asarray(rng.normal(size=shape).astype(np.float32))
    v0 = jnp.asarray(rng.normal(size=shape).astype(np.float32))
    gr = jnp.arange(h)[:, None]
    gc = jnp.arange(w)[None, :]
    masks = stencils.edge_masks(gr, gc, h, w)
    colors = stencils.color_masks(h, w)
    u, v, um, vm = u0, v0, u0, v0
    for _ in range(3):
        u, v = stencils.sor_step(u, v, ex, ey, et, invd, omega, colors)
        um, vm = stencils.sor_step_masked(um, vm, ex, ey, et, invd, omega,
                                          colors, masks)
    assert float(jnp.abs(u - um).max()) <= TOL
    assert float(jnp.abs(v - vm).max()) <= TOL


def test_sor_converges_faster_than_jacobi():
    """The reason the solver exists: measured curves (alpha=0.1, 1 px
    translation, 96x128) put the converged EPE at ~9.09e-5; Jacobi takes
    ~400 sweeps to get there while SOR(omega=1.5) arrives by 50 — and at
    matched budget x2 (Jacobi-100 vs SOR-50) SOR is >10x more accurate."""
    from hsflow.data.synthetic import translation_pair

    i1, i2, gt = translation_pair(96, 128, 1.0, 0.0, key=3)
    i1, i2 = jnp.asarray(i1), jnp.asarray(i2)

    def run(solver, iters, omega=1.5):
        f = hs_solve(i1, i2, HSConfig(alpha=0.1, iters=iters, solver=solver,
                                      omega=omega, backend="jnp"))
        fl = np.stack([np.asarray(f.u), np.asarray(f.v)], -1)
        return epe(interior(fl, 8), interior(gt, 8))

    e_converged = run("jacobi", 400)
    e_sor = run("sor", 50)
    assert e_sor <= e_converged * 1.05, (e_sor, e_converged)
    e_jacobi_100 = run("jacobi", 100)
    assert e_sor * 5 <= e_jacobi_100, (e_sor, e_jacobi_100)


def test_hs_solve_sor_backends_agree(kernel_mode):
    from hsflow.data.synthetic import translation_pair

    i1, i2, _ = translation_pair(48, 64, 1.0, 0.5, key=5)
    i1, i2 = jnp.asarray(i1), jnp.asarray(i2)
    fp = hs_solve(i1, i2, HSConfig(alpha=0.5, iters=20, solver="sor",
                                   backend="pallas"))
    fj = hs_solve(i1, i2, HSConfig(alpha=0.5, iters=20, solver="sor",
                                   backend="jnp"))
    # SOR runs the jnp sweeps on every backend; allow a few ULP for the
    # two separately compiled graphs (FMA contraction).
    assert float(jnp.abs(fp.u - fj.u).max()) <= 1e-5
    assert float(jnp.abs(fp.v - fj.v).max()) <= 1e-5


def test_config_validation():
    with pytest.raises(ValueError, match="solver"):
        HSConfig(solver="fancy")
    with pytest.raises(ValueError, match="omega"):
        HSConfig(omega=2.5)


@pytest.mark.parametrize(
    "my,mx,shape,s,backend",
    [
        (2, 4, (64, 96), 1, "jnp"),
        (4, 2, (64, 96), 2, "jnp"),  # blockwise: 2 sweeps/8-px halo exchange
        (2, 2, (57, 83), 1, "jnp"),  # odd shape -> pad-and-mask, odd parity
        (2, 4, (64, 96), 1, "pallas"),   # kernel backend: SOR tiles stay jnp
        (2, 2, (57, 83), 2, "pallas"),
    ],
)
def test_tiled_sor_matches_untiled(my, mx, shape, s, backend, kernel_mode):
    """SOR tiles exactly: per-block 4*s-px halos (one decay ring per color
    stage) + global-parity colors reproduce the untiled solve at any mesh
    shape, including tiles with odd global offsets."""
    from hsflow.config import MeshConfig
    from hsflow.dist import make_mesh
    from hsflow.dist.tiled_solver import hs_solve_tiled

    mesh = make_mesh(MeshConfig(batch=1, y=my, x=mx))
    rng = np.random.default_rng(11)
    i1 = jnp.asarray(rng.uniform(0, 1, shape).astype(np.float32))
    i2 = jnp.asarray(rng.uniform(0, 1, shape).astype(np.float32))
    cfg = HSConfig(alpha=0.3, iters=11, solver="sor", omega=1.7,
                   backend=backend)
    ft = hs_solve_tiled(i1, i2, cfg, mesh=mesh, halo_sweeps=s)
    fu = hs_solve(i1, i2, HSConfig(alpha=0.3, iters=11, solver="sor",
                                   omega=1.7, backend="jnp"))
    assert float(jnp.abs(ft.u - fu.u).max()) <= 1e-5
    assert float(jnp.abs(ft.v - fu.v).max()) <= 1e-5


def test_pyramid_sor_converges():
    """Coarse-to-fine + SOR compose (pyramid calls solver.sweeps per
    level): a 4 px shift resolves to sub-0.1 EPE with few sweeps."""
    from hsflow.config import PyramidConfig
    from hsflow.data.synthetic import translation_pair
    from hsflow.pyramid import hs_pyramid

    i1, i2, gt = translation_pair(96, 128, 4.0, 0.0, key=4)
    f = hs_pyramid(
        jnp.asarray(i1), jnp.asarray(i2),
        HSConfig(alpha=0.1, iters=60, solver="sor", omega=1.5,
                 backend="jnp"),
        PyramidConfig(levels=3),
    )
    fl = np.stack([np.asarray(f.u), np.asarray(f.v)], -1)
    assert epe(interior(fl, 8), interior(gt, 8)) < 0.1


def test_batched_sor_matches_loop():
    """hs_solve_batched(solver="sor") == per-image hs_solve (vmap routes
    each lane through the same sweep path)."""
    from hsflow.batch import hs_solve_batched

    rng = np.random.default_rng(7)
    i1 = jnp.asarray(rng.uniform(0, 1, (3, 40, 48)).astype(np.float32))
    i2 = jnp.asarray(rng.uniform(0, 1, (3, 40, 48)).astype(np.float32))
    cfg = HSConfig(alpha=0.5, iters=12, solver="sor", omega=1.6,
                   backend="jnp")
    fb = hs_solve_batched(i1, i2, cfg)
    for k in range(3):
        f = hs_solve(i1[k], i2[k], cfg)
        assert float(jnp.abs(fb.u[k] - f.u).max()) <= 1e-5
        assert float(jnp.abs(fb.v[k] - f.v).max()) <= 1e-5
