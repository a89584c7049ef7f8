"""Robust-penalty Horn-Schunck (`HSConfig(solver="robust")`).

Classic HS (reference scope, SURVEY.md §2.5) minimizes a QUADRATIC energy,
which oversmooths across motion boundaries — the best-known weakness of the
1981 model. This solver swaps both terms for the Charbonnier penalty
psi(s^2) = sqrt(s^2 + eps^2) (Black & Anandan 1996; Brox et al. 2004) and
minimizes by IRLS / lagged diffusivity: every `robust_update_every` sweeps
the weights

    wd = eps_d / sqrt(r^2 + eps_d^2),          r = Ex u + Ey v + Et
    ws = eps_s / sqrt(|grad u|^2 + |grad v|^2 + eps_s^2)

are refrozen from the current flow (normalized to a unit plateau, so in
smooth low-residual regions the system reduces to classic 4-neighbor HS and
alpha keeps its calibration), and the frozen-weight Euler-Lagrange system

    wd Ex (Ex u + Ey v + Et) = alpha^2 div(ws grad u)     (same for v)

is relaxed by pointwise-coupled Jacobi sweeps: neighbor edge weights
w_n = (ws_p + ws_n)/2 over the 4-neighborhood give the per-pixel 2x2 system

    [wd Ex^2 + a2 W, wd Ex Ey      ] [u]   [a2 Su - wd Ex Et]
    [wd Ex Ey,       wd Ey^2 + a2 W] [v] = [a2 Sv - wd Ey Et]

(W = sum w_n, Su = sum w_n u_n, a2 = alpha^2), solved in closed form per
pixel. Pure jnp/XLA on every backend — the sweep is elementwise + 4 shifts,
which XLA fuses; weight refreezes are O(n/update_every) extra passes.
Replicate-boundary shifts make the edge behave as a Neumann condition,
matching the classic solver's convention.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from hsflow.ops.stencils import (
    shift_down_row,
    shift_left_col,
    shift_right_col,
    shift_up_row,
)


def charbonnier_weights(u, v, ex, ey, et, eps_d: float, eps_s: float):
    """(wd, ws) per pixel from the current flow, unit-plateau normalized."""
    r = ex * u + ey * v + et
    wd = eps_d * lax.rsqrt(r * r + eps_d * eps_d)
    gxu = shift_left_col(u) - u
    gyu = shift_up_row(u) - u
    gxv = shift_left_col(v) - v
    gyv = shift_up_row(v) - v
    g2 = gxu * gxu + gyu * gyu + gxv * gxv + gyv * gyv
    ws = eps_s * lax.rsqrt(g2 + eps_s * eps_s)
    return wd, ws


def robust_step(u, v, ex, ey, et, wd, ws, alpha: float):
    """One frozen-weight Jacobi sweep of the IRLS inner system."""
    w_up = 0.5 * (ws + shift_down_row(ws))   # edge to (i-1, j)
    w_dn = 0.5 * (ws + shift_up_row(ws))     # edge to (i+1, j)
    w_lf = 0.5 * (ws + shift_right_col(ws))  # edge to (i, j-1)
    w_rt = 0.5 * (ws + shift_left_col(ws))   # edge to (i, j+1)
    w_sum = w_up + w_dn + w_lf + w_rt

    def nsum(a):
        return (
            w_up * shift_down_row(a)
            + w_dn * shift_up_row(a)
            + w_lf * shift_right_col(a)
            + w_rt * shift_left_col(a)
        )

    a2 = alpha * alpha
    a11 = wd * ex * ex + a2 * w_sum
    a22 = wd * ey * ey + a2 * w_sum
    a12 = wd * ex * ey
    b1 = a2 * nsum(u) - wd * ex * et
    b2 = a2 * nsum(v) - wd * ey * et
    inv_det = 1.0 / (a11 * a22 - a12 * a12)
    return (a22 * b1 - a12 * b2) * inv_det, (a11 * b2 - a12 * b1) * inv_det


def robust_sweeps(u, v, ex, ey, et, n: int, cfg) -> tuple:
    """n IRLS sweeps: weights refrozen every cfg.robust_update_every sweeps
    (first freeze happens at the zero/warm-start flow — weights start near
    the unit plateau, i.e. the first block IS classic HS). Each weight-block
    body is rematerialized (jax.checkpoint) so reverse-mode AD stores one
    state per block, not per sweep."""
    k = max(1, min(cfg.robust_update_every, n))
    n_blocks, rem = divmod(n, k)
    alpha = float(cfg.alpha)
    eps_d = float(cfg.robust_eps_d)
    eps_s = float(cfg.robust_eps_s)

    def block(uv, m):
        uu, vv = uv
        wd, ws = charbonnier_weights(uu, vv, ex, ey, et, eps_d, eps_s)

        def body(st, _):
            return robust_step(st[0], st[1], ex, ey, et, wd, ws, alpha), None

        uv, _ = lax.scan(body, (uu, vv), None, length=m)
        return uv

    # scan (not fori_loop) so the whole solve reverse-differentiates;
    # jax.checkpoint per block keeps the tape at one state per weight
    # block instead of one per sweep.
    block_ckpt = jax.checkpoint(block, static_argnums=(1,))

    uv = (u, v)
    if n_blocks > 0:
        uv, _ = lax.scan(
            lambda st, _: (block_ckpt(st, k), None), uv, None, length=n_blocks
        )
    if rem:
        uv = block_ckpt(uv, rem)
    return uv
