"""Geometric multigrid for the Horn-Schunck linear system (solver="multigrid").

The per-pyramid-level HS problem is one LINEAR system in (u, v):

    L(u, v) = (alpha^2 (u - ubar) + Ex (Ex u + Ey v),
               alpha^2 (v - vbar) + Ey (Ex u + Ey v))  =  b
    b       = (-Ex Et, -Ey Et)

whose fixed point the classic Jacobi/SOR sweeps approach one spectral
component at a time — at large alpha / weak texture the smooth error modes
decay as slowly as (1 - O(1/N^2)) per sweep. Multigrid eliminates them on
coarser grids where they are oscillatory: V-cycles with 4-color
Gauss-Seidel smoothing, full-weighting restriction, bilinear prolongation
(the classic real-time variational-flow recipe, Bruhn et al. 2005).

Coarse operators — the two ingredients measured to matter (both probed
numerically; the naive variants converge 10-100x slower or diverge):

  * Restrict the data-term PRODUCTS (Ex^2, Ex*Ey, Ey^2), not Ex/Ey:
    averaging an oscillatory gradient field cancels it and leaves the
    coarse system far too weak (overcorrection -> divergence at small
    alpha). The restricted product matrix is SPD by Cauchy-Schwarz, so
    coarse levels carry a full 2x2 data term and the smoother solves the
    per-pixel 2x2 exactly.
  * h^2 scaling: (u - ubar) discretizes -beta h^2 Laplacian, so the same
    continuum operator on a 2h grid needs the SMOOTHNESS:DATA ratio
    shifted 4x toward data. Implemented by scaling the restricted data
    products AND the restricted residual by 4 per level (identical to
    alpha^2/4 after dividing the equation by 4, but keeps alpha^2 away
    from fp32 underflow on deep hierarchies).

Correctness note: coarse grids only PRECONDITION — every cycle ends by
smoothing the true fine-level equation, so the converged solution is
exactly the fixed point of ops/stencils.jacobi_step (tests assert this);
a mis-built coarse operator could only slow convergence, never bias it.

Smoother: general-RHS exact per-pixel 2x2 solve under the 4-coloring
(ops/stencils.color_masks — an exact Gauss-Seidel ordering for the
8-neighbor stencil), omega = 1 (over-relaxation helps standalone SOR but
worsens the SMOOTHING factor multigrid needs):

    (alpha^2 I + M) x = alpha^2 [ubar; vbar] + g,   M = [exx exy; exy eyy]

with the closed-form 2x2 inverse; on the fine level M = d d^T and
g = -d Et reduce it exactly to SURVEY.md §2.5 eq. U.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from hsflow.config import HSConfig
from hsflow.ops import stencils

# V(NU1, NU2) cycles; coarsest grid solved by CS_SWEEPS GS sweeps.
NU1 = 2
NU2 = 2
CS_SWEEPS = 32
MIN_SIDE = 8  # stop coarsening when min(h, w) would drop below this


def hs_operator(u, v, exx, exy, eyy, a2):
    """Apply L (the homogeneous HS operator — rhs excluded)."""
    lu = a2 * (u - stencils.neighbor_avg(u)) + exx * u + exy * v
    lv = a2 * (v - stencils.neighbor_avg(v)) + exy * u + eyy * v
    return lu, lv


def residual(u, v, gu, gv, exx, exy, eyy, a2):
    lu, lv = hs_operator(u, v, exx, exy, eyy, a2)
    return gu - lu, gv - lv


def gs_general(u, v, gu, gv, lvl, n):
    """n sweeps of general-RHS 4-color Gauss-Seidel on L x = g.

    Per color: the per-pixel 2x2 system (alpha^2 I + M) x = alpha^2 nbar + g
    is solved EXACTLY via the closed-form inverse (idet precomputed)."""
    exx, exy, eyy, a2, idet, colors = lvl

    def step(_, uv):
        uu, vv = uv
        for cm in colors:
            mu = a2 * stencils.neighbor_avg(uu) + gu
            mv = a2 * stencils.neighbor_avg(vv) + gv
            xu = ((a2 + eyy) * mu - exy * mv) * idet
            xv = ((a2 + exx) * mv - exy * mu) * idet
            uu = jnp.where(cm, xu, uu)
            vv = jnp.where(cm, xv, vv)
        return uu, vv

    return lax.fori_loop(0, n, step, (u, v))


def restrict(a):
    """Full-weighting restriction: [1,2,1]x[1,2,1]/16 then 2x subsample
    (clamp edges — consistent with the Neumann boundary everywhere else).

    Each separable pass subsamples its own axis immediately (exactly
    pyramid.downsample2x's structure): bitwise identical to
    filter-then-`[::2, ::2]` since the per-axis passes are independent, but
    it keeps the second pass on half the rows."""
    t = stencils.shift_down_row(a) + 2.0 * a + stencils.shift_up_row(a)
    t = t[..., ::2, :]
    s = stencils.shift_right_col(t) + 2.0 * t + stencils.shift_left_col(t)
    return s[..., :, ::2] * (1.0 / 16.0)


def prolong(a, h: int, w: int):
    """Bilinear prolongation to (h, w): coarse points land on even fine
    indices, odd indices average their neighbors (clamp at the far edge)."""
    hc, wc = a.shape[-2:]
    rows = jnp.stack([a, 0.5 * (a + stencils.shift_up_row(a))], axis=-2)
    rows = rows.reshape(*a.shape[:-2], 2 * hc, wc)[..., :h, :]
    cols = jnp.stack(
        [rows, 0.5 * (rows + stencils.shift_left_col(rows))], axis=-1
    )
    return cols.reshape(*rows.shape[:-1], 2 * wc)[..., :w]


def _level(exx, exy, eyy, a2):
    h, w = exx.shape[-2:]
    det = (a2 + exx) * (a2 + eyy) - exy * exy  # >= a2^2 > 0 (SPD M)
    return (exx, exy, eyy, a2, 1.0 / det, stencils.color_masks(h, w))


def _build_levels(ex, ey, alpha: float):
    """Coefficient hierarchy, coarsened until MIN_SIDE. Data products are
    restricted and x4-scaled per level (module docstring)."""
    a2 = alpha * alpha
    exx, exy, eyy = ex * ex, ex * ey, ey * ey
    levels = [_level(exx, exy, eyy, a2)]
    while True:
        h, w = exx.shape[-2:]
        if min(h, w) <= 2 * MIN_SIDE or min(h, w) <= 3:
            return levels
        exx, exy, eyy = (4.0 * restrict(c) for c in (exx, exy, eyy))
        levels.append(_level(exx, exy, eyy, a2))


def _vcycle(levels, k: int, u, v, gu, gv):
    lvl = levels[k]
    if k == len(levels) - 1:
        return gs_general(u, v, gu, gv, lvl, CS_SWEEPS)
    u, v = gs_general(u, v, gu, gv, lvl, NU1)
    exx, exy, eyy, a2 = lvl[:4]
    ru, rv = residual(u, v, gu, gv, exx, exy, eyy, a2)
    # x4: same h^2 rescaling as the coarse data products.
    rcu, rcv = 4.0 * restrict(ru), 4.0 * restrict(rv)
    ze = jnp.zeros_like(rcu)
    ecu, ecv = _vcycle(levels, k + 1, ze, ze, rcu, rcv)
    h, w = u.shape[-2:]
    u = u + prolong(ecu, h, w)
    v = v + prolong(ecv, h, w)
    return gs_general(u, v, gu, gv, lvl, NU2)


def mg_solve(u, v, ex, ey, et, alpha: float, cycles: int):
    """`cycles` V(NU1,NU2) cycles on the HS system from a (u, v) guess.

    Work per cycle ~ (NU1+NU2) fine GS sweeps x 4/3 (geometric level sum);
    measured residual reduction and time-to-EPE vs relaxation are in
    tests/unit/test_multigrid.py."""
    levels = _build_levels(ex, ey, alpha)
    gu = -ex * et
    gv = -ey * et

    def body(_, uv):
        return _vcycle(levels, 0, uv[0], uv[1], gu, gv)

    return lax.fori_loop(0, cycles, body, (u, v))


def mg_sweeps(u, v, ex, ey, et, inv_den, n, cfg: HSConfig):
    """solver.sweeps adapter: cfg.iters counts V-CYCLES for this solver
    (typical 1-5; each does ~(NU1+NU2)*4/3 sweep-equivalents of work).
    inv_den is unused (levels build 2x2 idet fields instead) but kept for
    the uniform sweeps() signature."""
    del inv_den
    return mg_solve(u, v, ex, ey, et, cfg.alpha, n)
