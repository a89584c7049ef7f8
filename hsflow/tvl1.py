"""TV-L1 optical flow (Zach, Pock & Bischof, DAGM 2007) — third model family.

The reference repo is Horn-Schunck only (SURVEY.md §2a); this module is a
strict capability extension alongside `lucas_kanade.py`: an L1 data term with
a total-variation prior, minimized by the classic duality-based alternation
(pointwise thresholding for the data term, Chambolle's projected dual ascent
for the TV term). Where quadratic HS blurs motion boundaries and LK needs
texture, TV-L1 keeps boundaries piecewise-constant sharp and is robust to
illumination outliers — the standard third member of this model-family trio.

Design (plain jnp — every inner step is elementwise arithmetic plus 1-px
clamp shifts that XLA fuses):
  * forward-difference gradient / adjoint divergence pairs are the
    slice+concat shifts of `ops/stencils.py` (one fusion, no pads);
  * the dual fields' structural zeros (last col of p_x, last row of p_y) are
    masked after every update so the divergence formula stays uniform — the
    discrete adjoint identity <grad u, p> == <u, -div p> holds exactly;
  * the inner alternation is a `lax.fori_loop` over a flat 6-field state —
    fixed trip counts, one jit region for the whole pyramid, vmap-able;
  * the only gather is the shared backward warp (`pyramid.warp`, tiled
    formulation), once per warp iteration — never inside the inner loop;
  * the optional 3x3 median filter between warps (the single biggest
    robustness upgrade in practical TV-L1, cf. Sun et al. CVPR 2010) is a
    9-way stacked-shift `jnp.sort` — vectorized, no data-dependent control.

Mesh path: like `lucas_kanade.lk_solve_tiled`, the solver distributes as
GLOBAL jit ops under `with_sharding_constraint` — GSPMD inserts the 1-px
halo collectives for the shifts itself, so tiled == untiled to float
tolerance by construction (same arithmetic, same association order).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from jax import lax

from hsflow.config import PyramidConfig, TVL1Config
from hsflow.ops import stencils
from hsflow.pyramid import gaussian_pyramid, upsample_flow, warp
from hsflow.solver import Flow

_G2_EPS = 1e-9  # guards the |grad I|^2 division in textureless pixels


def grad_forward(a: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Forward differences with Neumann boundaries: gx[..., j] = a[j+1] - a[j]
    (structurally 0 at the last column via the clamp shift), gy likewise on
    rows. The discretization of Chambolle (2004) §2."""
    gx = stencils.shift_left_col(a) - a
    gy = stencils.shift_up_row(a) - a
    return gx, gy


def _zshift_right_col(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.concatenate(
        [jnp.zeros_like(a[..., :, :1]), a[..., :, :-1]], axis=-1
    )


def _zshift_down_row(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.concatenate(
        [jnp.zeros_like(a[..., :1, :]), a[..., :-1, :]], axis=-2
    )


def _mask_dual(px: jnp.ndarray, py: jnp.ndarray):
    """Zero the structurally-unused dual entries (last col of px, last row of
    py) so `divergence` is the EXACT adjoint of `grad_forward`."""
    px = jnp.concatenate([px[..., :, :-1], jnp.zeros_like(px[..., :, -1:])],
                         axis=-1)
    py = jnp.concatenate([py[..., :-1, :], jnp.zeros_like(py[..., -1:, :])],
                         axis=-2)
    return px, py


def divergence(px: jnp.ndarray, py: jnp.ndarray) -> jnp.ndarray:
    """Backward-difference divergence, the negative adjoint of
    `grad_forward` given `_mask_dual`-ed duals: div[j] = p[j] - p[j-1] with
    p[-1] = 0 (so div at the first col/row is p itself, at the last it is
    -p[-2])."""
    return (px - _zshift_right_col(px)) + (py - _zshift_down_row(py))


def _safe_norm(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """sqrt(x^2 + y^2) with a finite gradient at the origin (double-where:
    sqrt'(0) = inf would NaN the whole backward pass; forward values are
    bitwise identical to the naive form)."""
    n2 = x * x + y * y
    pos = n2 > 0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, n2, 1.0)), 0.0)


def median3(a: jnp.ndarray) -> jnp.ndarray:
    """3x3 median with replicate borders: the 9 clamp-shifted copies run
    through the classic 19-exchange median-of-9 selection network (Paeth's
    sorting-network construction) — pure pairwise min/max, no gathers, no
    data-dependent control, and ~4x cheaper than sorting the full 9-stack
    (the round-5 TV-L1 profile showed the between-warp medians as a
    leading residual cost). Selection networks compute the exact order
    statistic, so the result is identical to the sort formulation
    (asserted in tests/unit/test_tvl1.py)."""
    up, dn = stencils.shift_up_row(a), stencils.shift_down_row(a)
    rows = (dn, a, up)
    p = []
    for r in rows:
        p.extend((stencils.shift_right_col(r), r, stencils.shift_left_col(r)))

    def ex(i, j):
        p[i], p[j] = jnp.minimum(p[i], p[j]), jnp.maximum(p[i], p[j])

    for i, j in ((1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7),
                 (1, 2), (4, 5), (7, 8), (0, 3), (5, 8), (4, 7),
                 (3, 6), (1, 4), (2, 5), (4, 7), (4, 2), (6, 4),
                 (4, 2)):
        ex(i, j)
    return p[4]


def _central_grad(a: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    gx = 0.5 * (stencils.shift_left_col(a) - stencils.shift_right_col(a))
    gy = 0.5 * (stencils.shift_up_row(a) - stencils.shift_down_row(a))
    return gx, gy


def tvl1_warp_iteration(
    i1: jnp.ndarray,
    i2: jnp.ndarray,
    u1: jnp.ndarray,
    u2: jnp.ndarray,
    cfg: TVL1Config,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One warp-and-relinearize outer step of Zach et al. (2007) Alg. 1.

    Warps frame 2 (and its gradient) by the current flow (u1, u2) = (u, v),
    linearizes the residual rho(u) = I2w + (u - u0)·gradI2w - I1 around it,
    then runs `cfg.iters` alternations of
      v-step: pointwise shrinkage of the L1 data term (three-case threshold
              on rho against lambda·theta·|g|^2),
      u-step: one Chambolle projected-ascent step per flow component —
              u_k = v_k + theta·div p_k;  p_k <- (p_k + (tau/theta) grad u_k)
              / (1 + (tau/theta) |grad u_k|)
    (the IPOL/Sanchez-et-al. sign convention: with `divergence` the NEGATIVE
    adjoint of `grad_forward`, the TV-prox solution is v + theta·div p, and
    it pairs with dual *ascent* p + sigma·grad u. The opposite u-step sign
    pairs with dual descent p - sigma·grad u; mixing the two diverges.)
    """
    # "auto" means CHECKED for TV-L1: the tiled warp's per-tile smoothness
    # contract (<= 4 px deviation from the tile's mean flow) is exactly
    # what sharp TV-L1 motion boundaries can break — so the checked warp
    # measures the deviation on device and takes the tiled path only when
    # it is provably exact, falling back to the reference gather otherwise.
    i2w = warp(i2, u1, u2, "checked" if cfg.warp == "auto" else cfg.warp)
    gx, gy = _central_grad(i2w)
    rho0 = i2w - i1 - u1 * gx - u2 * gy   # rho(u) = rho0 + u·g, affine in u
    g2 = gx * gx + gy * gy
    th = cfg.lambda_ * cfg.theta * g2
    inv_g2 = 1.0 / (g2 + _G2_EPS)
    sigma = cfg.tau / cfg.theta

    def body(_, state):
        u1, u2, p1x, p1y, p2x, p2y = state
        # --- v-step: closed-form prox of the L1 data term (pointwise) ------
        rho = rho0 + u1 * gx + u2 * gy
        step = jnp.where(
            rho < -th,
            cfg.lambda_ * cfg.theta,
            jnp.where(rho > th, -cfg.lambda_ * cfg.theta, -rho * inv_g2),
        )
        v1 = u1 + step * gx
        v2 = u2 + step * gy
        # --- u-step: one dual ascent step of Chambolle's TV prox per field -
        u1 = v1 + cfg.theta * divergence(p1x, p1y)
        u2 = v2 + cfg.theta * divergence(p2x, p2y)
        d1x, d1y = grad_forward(u1)
        d2x, d2y = grad_forward(u2)
        n1 = 1.0 + sigma * _safe_norm(d1x, d1y)
        n2 = 1.0 + sigma * _safe_norm(d2x, d2y)
        p1x, p1y = _mask_dual((p1x + sigma * d1x) / n1, (p1y + sigma * d1y) / n1)
        p2x, p2y = _mask_dual((p2x + sigma * d2x) / n2, (p2y + sigma * d2y) / n2)
        return u1, u2, p1x, p1y, p2x, p2y

    z = jnp.zeros_like(u1)
    state = (u1, u2, z, z, z, z)
    u1, u2, *_ = lax.fori_loop(0, cfg.iters, body, state)
    if cfg.median:
        u1, u2 = median3(u1), median3(u2)
    return u1, u2


def _tvl1_level(i1, i2, u1, u2, cfg: TVL1Config, warps: int):
    for _ in range(warps):  # unrolled: warps is small (1-5) and static
        u1, u2 = tvl1_warp_iteration(i1, i2, u1, u2, cfg)
    return u1, u2


def _tvl1_pyramid_body(
    i1: jnp.ndarray,
    i2: jnp.ndarray,
    cfg: TVL1Config,
    pyr: PyramidConfig,
    constrain=lambda a: a,
) -> Flow:
    dtype = jnp.dtype(cfg.dtype)
    i1, i2 = i1.astype(dtype), i2.astype(dtype)
    # Jointly rescale the pair to [0, 255] (the IPOL/Sanchez-et-al.
    # convention lambda is calibrated for). The published lambda=0.15
    # over-regularizes [0,1] frames by ~255x — measured on the two-motion
    # seam: band EPE 0.85 raw vs 0.062 normalized (vs HS 0.25). The min/max
    # are global reductions, so the tiled path stays byte-identical (GSPMD
    # all-reduces them) and vmap gives per-pair normalization when batched.
    lo = jnp.minimum(i1.min(), i2.min())
    hi = jnp.maximum(i1.max(), i2.max())
    scale = 255.0 / jnp.maximum(hi - lo, jnp.asarray(1e-6, dtype))
    i1 = (i1 - lo) * scale
    i2 = (i2 - lo) * scale
    p1 = [constrain(f) for f in gaussian_pyramid(i1, pyr.levels)]
    p2 = [constrain(f) for f in gaussian_pyramid(i2, pyr.levels)]
    # Per-level warp counts come from TVL1Config, NOT pyr.iters_per_level:
    # that field counts Jacobi sweeps for HS, and silently reinterpreting an
    # HS-tuned (100, 50, 25) as warp counts would be a ~20x runtime surprise.
    warps: Sequence[int] = cfg.warps_per_level or (cfg.warps,) * pyr.levels

    flow: Optional[Flow] = None
    for level in range(pyr.levels - 1, -1, -1):
        f1, f2 = p1[level], p2[level]
        if flow is None:
            u1 = jnp.zeros_like(f1)
            u2 = jnp.zeros_like(f1)
        else:
            flow = upsample_flow(flow, f1.shape[-2:])
            u1, u2 = constrain(flow.u), constrain(flow.v)
        u1, u2 = _tvl1_level(f1, f2, u1, u2, cfg, warps[level])
        flow = Flow(constrain(u1), constrain(u2))
    return flow


@partial(jax.jit, static_argnames=("cfg", "pyr"))
def _tvl1_impl(i1, i2, cfg: TVL1Config, pyr: PyramidConfig) -> Flow:
    return _tvl1_pyramid_body(i1, i2, cfg, pyr)


def tvl1_solve(
    i1: jnp.ndarray,
    i2: jnp.ndarray,
    cfg: TVL1Config = TVL1Config(),
    pyr: PyramidConfig = PyramidConfig(levels=1, iters_per_level=()),
) -> Flow:
    """TV-L1 flow for the frame pair (i1, i2).

    `pyr.levels == 1` solves at full resolution (displacements up to ~1 px
    per warp iteration); multi-level handles large motions exactly as the HS
    pyramid does. Like LK (and unlike HS), every level refines the SAME flow
    field — the model relinearizes around the warped frame, so there is no
    residual-summing step. `pyr.iters_per_level` overrides warps per level.
    """
    if i1.shape != i2.shape:
        raise ValueError(f"frame shapes differ: {i1.shape} vs {i2.shape}")
    if i1.ndim != 2:
        raise ValueError(
            "tvl1_solve takes single 2-D grayscale frames; use "
            "tvl1_solve_batched for leading batch axes"
        )
    min_side = min(i1.shape[-2:])
    if min_side // (2 ** (pyr.levels - 1)) < 8:
        raise ValueError(
            f"{pyr.levels} levels would shrink a {i1.shape[-2:]} frame below 8 px"
        )
    if cfg.warps_per_level and len(cfg.warps_per_level) != pyr.levels:
        raise ValueError(
            f"warps_per_level {cfg.warps_per_level} must match levels={pyr.levels}"
        )
    return _tvl1_impl(i1, i2, cfg, pyr)


@partial(jax.jit, static_argnames=("cfg", "pyr"))
def _tvl1_batched_impl(i1, i2, cfg: TVL1Config, pyr: PyramidConfig) -> Flow:
    return jax.vmap(lambda a, b: _tvl1_pyramid_body(a, b, cfg, pyr))(i1, i2)


def tvl1_solve_batched(
    i1: jnp.ndarray,
    i2: jnp.ndarray,
    cfg: TVL1Config = TVL1Config(),
    pyr: PyramidConfig = PyramidConfig(levels=1, iters_per_level=()),
    mesh=None,
) -> Flow:
    """TV-L1 over a (B, H, W) stack of frame pairs (vmap inside jit). With
    `mesh`, the stack shards over its "batch" axis first so GSPMD runs each
    chip's lanes locally, exactly as batch.py."""
    if i1.ndim != 3:
        raise ValueError(f"expected (B, H, W) frame stacks, got {i1.shape}")
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        sharding = NamedSharding(mesh, P("batch", None, None))
        i1 = jax.device_put(i1, sharding)
        i2 = jax.device_put(i2, sharding)
    return _tvl1_batched_impl(i1, i2, cfg, pyr)


@partial(jax.jit, static_argnames=("cfg", "pyr", "mesh"))
def _tvl1_tiled_impl(i1, i2, cfg: TVL1Config, pyr: PyramidConfig, mesh) -> Flow:
    from jax.sharding import NamedSharding, PartitionSpec as P

    spec = NamedSharding(mesh, P("y", "x"))

    def constrain(a):
        return jax.lax.with_sharding_constraint(a, spec)

    return _tvl1_pyramid_body(constrain(i1), constrain(i2), cfg, pyr, constrain)


def tvl1_solve_tiled(
    i1: jnp.ndarray,
    i2: jnp.ndarray,
    cfg: TVL1Config = TVL1Config(),
    pyr: PyramidConfig = PyramidConfig(levels=1, iters_per_level=()),
    mesh=None,
) -> Flow:
    """Spatially tiled TV-L1 over a ("y", "x") device mesh (SURVEY.md §2b
    P2), via per-level GSPMD sharding constraints like `lk_solve_tiled` —
    XLA schedules the shifts' 1-px halo collectives, and the arithmetic is
    byte-identical to the untiled path."""
    if i1.ndim != 2:
        raise ValueError("tvl1_solve_tiled takes single 2-D grayscale frames")
    if i1.shape != i2.shape:
        raise ValueError(f"frame shapes differ: {i1.shape} vs {i2.shape}")
    if mesh is None:
        raise ValueError("tvl1_solve_tiled requires a mesh (use tvl1_solve)")
    return _tvl1_tiled_impl(i1, i2, cfg, pyr, mesh)
