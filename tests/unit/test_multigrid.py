"""Multigrid solver (cfg.solver="multigrid"): operator/smoother identities +
the convergence claim.

Rungs: (1) the general-RHS GS smoother with g = -d*Et is exactly
4-color SOR at omega=1 (the rank-1 fine-level reduction of the 2x2
solve); (2) the residual vanishes at the Jacobi fixed point (operator and
rhs define the SAME system the classic sweeps solve); (3) restriction /
prolongation shape+value sanity on odd sizes; (4) the reason it exists:
at alpha=1 a couple of V-cycles (~11 fine-sweep work equivalents) reach
the EPE that Jacobi needs ~1600 sweeps for.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from hsflow import multigrid as mg
from hsflow.config import HSConfig
from hsflow.metrics import epe, interior
from hsflow.ops import stencils
from hsflow.solver import hs_solve


def _system(h, w, alpha, seed=0):
    rng = np.random.default_rng(seed)
    i1 = jnp.asarray(rng.uniform(0, 1, (h, w)).astype(np.float32))
    i2 = jnp.asarray(rng.uniform(0, 1, (h, w)).astype(np.float32))
    ex, ey, et = stencils.derivatives(i1, i2)
    return ex, ey, et, alpha * alpha


def test_smoother_is_sor_omega1_on_fine_level():
    ex, ey, et, a2 = _system(24, 40, 0.5, seed=1)
    invd = 1.0 / (a2 + ex * ex + ey * ey)
    colors = stencils.color_masks(24, 40)
    # rank-1 data matrix: det = a2^2 + a2(ex^2+ey^2) = a2 * den
    idet = 1.0 / ((a2 + ex * ex) * (a2 + ey * ey) - (ex * ey) ** 2)
    lvl = (ex * ex, ex * ey, ey * ey, a2, idet, colors)
    gu, gv = -ex * et, -ey * et
    z = jnp.zeros_like(ex)
    u1, v1 = mg.gs_general(z, z, gu, gv, lvl, 3)
    u2, v2 = z, z
    for _ in range(3):
        u2, v2 = stencils.sor_step(u2, v2, ex, ey, et, invd, 1.0, colors)
    assert float(jnp.abs(u1 - u2).max()) <= 1e-5
    assert float(jnp.abs(v1 - v2).max()) <= 1e-5


def test_residual_vanishes_at_jacobi_fixed_point():
    ex, ey, et, a2 = _system(32, 48, 0.5, seed=2)
    invd = 1.0 / (a2 + ex * ex + ey * ey)
    u = jnp.zeros_like(ex)
    v = jnp.zeros_like(ex)
    for _ in range(4000):
        u, v = stencils.jacobi_step(u, v, ex, ey, et, invd)
    ru, rv = mg.residual(u, v, -ex * et, -ey * et,
                         ex * ex, ex * ey, ey * ey, a2)
    assert float(jnp.abs(ru).max()) <= 1e-5
    assert float(jnp.abs(rv).max()) <= 1e-5


@pytest.mark.parametrize("shape", [(17, 23), (16, 24)])
def test_restrict_prolong_shapes_and_constants(shape):
    """Full weighting preserves constants exactly (weights sum to 1);
    bilinear prolongation of a constant is that constant, at even AND odd
    sizes; prolong(restrict) round-trips the shape."""
    h, w = shape
    a = jnp.full((h, w), 3.25, jnp.float32)
    r = mg.restrict(a)
    assert r.shape == ((h + 1) // 2, (w + 1) // 2)
    assert float(jnp.abs(r - 3.25).max()) == 0.0
    p = mg.prolong(r, h, w)
    assert p.shape == (h, w)
    assert float(jnp.abs(p - 3.25).max()) == 0.0


def test_vcycle_converges_to_jacobi_fixed_point():
    """Coarse grids only precondition: the mg solution approaches the SAME
    fixed point the classic sweeps define."""
    ex, ey, et, a2 = _system(64, 96, 1.0, seed=3)
    invd = 1.0 / (a2 + ex * ex + ey * ey)
    u = jnp.zeros_like(ex)
    v = jnp.zeros_like(ex)
    for _ in range(6000):
        u, v = stencils.jacobi_step(u, v, ex, ey, et, invd)
    z = jnp.zeros_like(ex)
    um, vm = mg.mg_solve(z, z, ex, ey, et, 1.0, 8)
    assert float(jnp.abs(um - u).max()) <= 5e-3
    assert float(jnp.abs(vm - v).max()) <= 5e-3


def test_mg_beats_jacobi_by_100x_at_alpha1():
    """The headline: 2 V-cycles (~11 fine-sweep work equivalents) reach the
    EPE Jacobi needs ~1600 sweeps for on a 1 px translation at alpha=1."""
    from hsflow.data.synthetic import translation_pair

    i1, i2, gt = translation_pair(256, 384, 1.0, 0.0, key=3)
    i1, i2 = jnp.asarray(i1), jnp.asarray(i2)

    def run(solver, iters):
        f = hs_solve(i1, i2, HSConfig(alpha=1.0, iters=iters, solver=solver,
                                      backend="jnp"))
        fl = np.stack([np.asarray(f.u), np.asarray(f.v)], -1)
        return epe(interior(fl, 8), interior(gt, 8))

    e_mg2 = run("multigrid", 2)       # ~11 sweep-equivalents of work
    e_j1600 = run("jacobi", 1600)
    assert e_mg2 <= e_j1600 * 1.1, (e_mg2, e_j1600)
    e_j100 = run("jacobi", 100)       # ~9x the mg work, far worse EPE
    assert e_mg2 * 20 <= e_j100, (e_mg2, e_j100)


def test_batched_mg_matches_loop():
    from hsflow.batch import hs_solve_batched

    rng = np.random.default_rng(7)
    i1 = jnp.asarray(rng.uniform(0, 1, (2, 40, 48)).astype(np.float32))
    i2 = jnp.asarray(rng.uniform(0, 1, (2, 40, 48)).astype(np.float32))
    cfg = HSConfig(alpha=1.0, iters=2, solver="multigrid", backend="jnp")
    fb = hs_solve_batched(i1, i2, cfg)
    for k in range(2):
        f = hs_solve(i1[k], i2[k], cfg)
        assert float(jnp.abs(fb.u[k] - f.u).max()) <= 1e-5


@pytest.mark.parametrize("my,mx", [(2, 4), (4, 2), (1, 8)])
def test_tiled_multigrid_matches_untiled(my, mx):
    """GSPMD-sharded V-cycle == single-device V-cycle (same arithmetic,
    XLA-scheduled halos), at several mesh shapes."""
    from hsflow.config import MeshConfig
    from hsflow.data.synthetic import translation_pair
    from hsflow.dist import make_mesh
    from hsflow.dist.tiled_solver import hs_solve_tiled

    i1, i2, _ = translation_pair(64, 96, 1.0, 0.0, key=3)
    i1, i2 = jnp.asarray(i1), jnp.asarray(i2)
    cfg = HSConfig(alpha=1.0, iters=2, solver="multigrid", backend="jnp")
    mesh = make_mesh(MeshConfig(batch=1, y=my, x=mx))
    ft = hs_solve_tiled(i1, i2, cfg, mesh=mesh)
    fu = hs_solve(i1, i2, cfg)
    # GSPMD may reassociate the restriction/prolongation convs (measured
    # 1.5e-6 at 1x8); "same arithmetic" here is float-tolerance, not
    # bitwise like the hand-rolled halo paths.
    assert float(jnp.abs(ft.u - fu.u).max()) <= 5e-6
    assert float(jnp.abs(ft.v - fu.v).max()) <= 5e-6


def test_tiled_multigrid_odd_shape_and_tol():
    """Uneven GSPMD shardings (odd H x W) and the tol route both match."""
    from hsflow.config import MeshConfig
    from hsflow.data.synthetic import translation_pair
    from hsflow.dist import make_mesh
    from hsflow.dist.tiled_solver import hs_solve_tiled

    i1, i2, _ = translation_pair(37, 115, 1.0, 0.0, key=5)
    i1, i2 = jnp.asarray(i1), jnp.asarray(i2)
    mesh = make_mesh(MeshConfig(batch=1, y=2, x=4))
    cfg = HSConfig(alpha=1.0, iters=3, solver="multigrid", backend="jnp")
    ft = hs_solve_tiled(i1, i2, cfg, mesh=mesh)
    fu = hs_solve(i1, i2, cfg)
    assert float(jnp.abs(ft.u - fu.u).max()) <= 5e-6
    cfg_t = HSConfig(alpha=1.0, iters=8, tol=1e-30, solver="multigrid",
                     backend="jnp")
    cfg_f = HSConfig(alpha=1.0, iters=8, solver="multigrid", backend="jnp")
    ftt = hs_solve_tiled(i1, i2, cfg_t, mesh=mesh)
    ftf = hs_solve_tiled(i1, i2, cfg_f, mesh=mesh)
    assert float(jnp.abs(ftt.u - ftf.u).max()) == 0.0


def test_pyramid_tiled_routes_multigrid():
    """Regression: the CLI --mesh route (hs_pyramid_tiled) must run REAL
    V-cycles for solver='multigrid' at any level count (it silently ran
    plain Jacobi sweeps before; multi-level was rejected until round 3)."""
    from hsflow.config import MeshConfig, PyramidConfig
    from hsflow.data.synthetic import translation_pair
    from hsflow.dist import hs_pyramid_tiled, make_mesh
    from hsflow.pyramid import hs_pyramid

    i1, i2, _ = translation_pair(64, 96, 1.0, 0.0, key=3)
    i1, i2 = jnp.asarray(i1), jnp.asarray(i2)
    mesh = make_mesh(MeshConfig(batch=1, y=2, x=2))
    cfg = HSConfig(alpha=1.0, iters=2, solver="multigrid", backend="jnp")
    ft = hs_pyramid_tiled(i1, i2, cfg, PyramidConfig(levels=1), mesh=mesh)
    fu = hs_solve(i1, i2, cfg)
    assert float(jnp.abs(ft.u - fu.u).max()) <= 5e-6
    ft3 = hs_pyramid_tiled(i1, i2, cfg, PyramidConfig(levels=3), mesh=mesh)
    fu3 = hs_pyramid(i1, i2, cfg, PyramidConfig(levels=3))
    assert float(jnp.abs(ft3.u - fu3.u).max()) <= 5e-6


@pytest.mark.parametrize("shape", [(17, 23), (16, 24), (33, 48)])
def test_restrict_matches_2d_stride_reference(shape):
    """restrict subsamples each axis inside its own separable filter pass
    (cheaper than one 2-D stride-2 slice of the filtered field); this pins
    it BITWISE to
    the straightforward filter-everything-then-[::2, ::2] formulation at
    even and odd sizes."""
    from hsflow.ops import stencils

    rng = np.random.default_rng(7)
    a = jnp.asarray(rng.uniform(-1, 1, shape).astype(np.float32))
    t = stencils.shift_down_row(a) + 2.0 * a + stencils.shift_up_row(a)
    s = stencils.shift_right_col(t) + 2.0 * t + stencils.shift_left_col(t)
    ref = s[::2, ::2] * (1.0 / 16.0)
    out = mg.restrict(a)
    assert out.shape == ref.shape
    assert float(jnp.abs(out - ref).max()) == 0.0
