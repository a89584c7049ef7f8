"""Dense pyramidal Lucas-Kanade optical flow — a second model family.

Lucas & Kanade (IJCAI 1981), iterative pyramidal form per Bouguet (2000).
The reference repo is Horn-Schunck only (SURVEY.md §2a); this module is a
strict capability extension: LOCAL windowed least squares (flow constant
over a small window) versus HS's GLOBAL smoothness prior. LK shines on
strongly textured scenes and needs no iteration-count tuning; HS fills in
flow over textureless regions. Both share the pyramid, warp, metrics, viz,
and I/O subsystems.

Design (plain jnp, no custom kernels):
  * the structure tensor's window sums are two SEPARABLE 1-D box sums via
    `lax.reduce_window` — XLA lowers these to vectorized adds, keeping
    the whole refinement elementwise/fusible;
  * the per-pixel 2x2 normal equations are solved closed-form (elementwise
    arithmetic, no linalg calls);
  * the only gather is the shared backward warp, which reuses the pyramid's
    tiled formulation (pyramid.warp — one coarse block fetch per tile);
  * fixed refinement counts per level — no data-dependent control flow, the
    whole pyramid is one jit region, vmap-able over a batch axis.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from jax import lax

from hsflow.config import LKConfig, PyramidConfig
from hsflow.ops import stencils
from hsflow.pyramid import _B5, gaussian_pyramid, upsample_flow, warp
from hsflow.solver import Flow


def _blur5(a: jnp.ndarray) -> jnp.ndarray:
    """Separable 5-tap binomial blur (the pyramid's kernel, no subsample)."""
    r1, r3 = stencils.shift_down_row(a), stencils.shift_up_row(a)
    r2, r4 = stencils.shift_down_row(r1), stencils.shift_up_row(r3)
    a = _B5[2] * a + _B5[1] * (r1 + r3) + _B5[0] * (r2 + r4)
    c1, c3 = stencils.shift_right_col(a), stencils.shift_left_col(a)
    c2, c4 = stencils.shift_right_col(c1), stencils.shift_left_col(c3)
    return _B5[2] * a + _B5[1] * (c1 + c3) + _B5[0] * (c2 + c4)


def box_sum(a: jnp.ndarray, window: int) -> jnp.ndarray:
    """Separable `window` x `window` box sum, SAME extent (sums shrink over
    the available support at the borders — the standard LK convention)."""
    a = lax.reduce_window(
        a, 0.0, lax.add, (window, 1), (1, 1), "SAME"
    )
    return lax.reduce_window(a, 0.0, lax.add, (1, window), (1, 1), "SAME")


def lk_refine(
    i1: jnp.ndarray,
    i2: jnp.ndarray,
    u: jnp.ndarray,
    v: jnp.ndarray,
    cfg: LKConfig,
    warp_radius: int = 0,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One warp-and-solve Newton refinement of (u, v) at the current level.

    Warps frame 2 by the current flow, then solves the per-pixel windowed
    normal equations  G d = -b  with  G = sum_w [Ex^2, ExEy; ExEy, Ey^2]
    (+ eps on the diagonal) and b = sum_w [Ex*Et, Ey*Et].

    `warp_radius` is the tiled warp's select half-width (0 = on-device
    auto, PyramidConfig.warp_radius). LK does `iters` warps per LEVEL —
    one per Newton refinement, 3x the HS pyramid's warp count — so the
    round-5 auto radius (R=2 select when the per-tile deviation proves it
    exact) pays here more than anywhere else.
    """
    i2w = warp(i2, u, v, cfg.warp, warp_radius)
    ex, ey, et = stencils.derivatives(i1, i2w, "central")
    g11 = box_sum(ex * ex, cfg.window) + cfg.eps
    g12 = box_sum(ex * ey, cfg.window)
    g22 = box_sum(ey * ey, cfg.window) + cfg.eps
    b1 = box_sum(ex * et, cfg.window)
    b2 = box_sum(ey * et, cfg.window)
    inv_det = 1.0 / (g11 * g22 - g12 * g12)
    du = (g12 * b2 - g22 * b1) * inv_det
    dv = (g12 * b1 - g11 * b2) * inv_det
    if cfg.max_step > 0:
        # Guard rail for textureless windows where the regularized system
        # is near-singular: one refinement may not move farther than the
        # linearization is valid for anyway.
        du = jnp.clip(du, -cfg.max_step, cfg.max_step)
        dv = jnp.clip(dv, -cfg.max_step, cfg.max_step)
    return u + du, v + dv


def _lk_level(i1, i2, u, v, cfg: LKConfig, iters: int, warp_radius: int = 0):
    for _ in range(iters):  # unrolled: iters is small (2-5) and static
        u, v = lk_refine(i1, i2, u, v, cfg, warp_radius)
        if cfg.smooth:
            # Binomial flow smoothing between refinements. Measured
            # (128x192 band-limited 1px-shift pair): without it, per-pixel
            # noise GROWS ~22%/refinement (interpolation residuals feed
            # back through weak-texture windows; EPE 0.056 at it2 ->
            # 0.19 at it8); with it, the iteration is stable (0.036 ->
            # 0.045). A weak local-global hybrid in the Bruhn et al.
            # sense, at two separable-blur cost.
            u, v = _blur5(u), _blur5(v)
    return u, v


def _lk_pyramid_body(
    i1: jnp.ndarray,
    i2: jnp.ndarray,
    cfg: LKConfig,
    pyr: PyramidConfig,
    constrain=lambda a: a,
) -> Flow:
    dtype = jnp.dtype(cfg.dtype)
    p1 = [constrain(f) for f in gaussian_pyramid(i1.astype(dtype), pyr.levels)]
    p2 = [constrain(f) for f in gaussian_pyramid(i2.astype(dtype), pyr.levels)]
    iters: Sequence[int] = pyr.iters_per_level or (cfg.iters,) * pyr.levels

    flow: Optional[Flow] = None
    for level in range(pyr.levels - 1, -1, -1):
        f1, f2 = p1[level], p2[level]
        if flow is None:
            u = jnp.zeros_like(f1)
            v = jnp.zeros_like(f1)
        else:
            flow = upsample_flow(flow, f1.shape[-2:])
            u, v = constrain(flow.u), constrain(flow.v)
        u, v = _lk_level(f1, f2, u, v, cfg, iters[level], pyr.warp_radius)
        flow = Flow(constrain(u), constrain(v))
    return flow


@partial(jax.jit, static_argnames=("cfg", "pyr"))
def _lk_impl(i1, i2, cfg: LKConfig, pyr: PyramidConfig) -> Flow:
    return _lk_pyramid_body(i1, i2, cfg, pyr)


def lk_solve(
    i1: jnp.ndarray,
    i2: jnp.ndarray,
    cfg: LKConfig = LKConfig(),
    pyr: PyramidConfig = PyramidConfig(levels=1, iters_per_level=()),
) -> Flow:
    """Dense (pyramidal) Lucas-Kanade flow for the frame pair (i1, i2).

    `pyr.levels == 1` is classic single-level iterative LK; multi-level
    handles displacements beyond the window radius exactly as the HS
    pyramid does (upsample x2, warp, refine — SURVEY.md §2.5 PYR). Every
    level refines the SAME flow field (LK linearizes around the current
    warp), so there is no residual-summing step.
    """
    if i1.shape != i2.shape:
        raise ValueError(f"frame shapes differ: {i1.shape} vs {i2.shape}")
    if i1.ndim != 2:
        raise ValueError(
            "lk_solve takes single 2-D grayscale frames; use "
            "lk_solve_batched for leading batch axes"
        )
    min_side = min(i1.shape[-2:])
    if min_side // (2 ** (pyr.levels - 1)) < 8:
        raise ValueError(
            f"{pyr.levels} levels would shrink a {i1.shape[-2:]} frame below 8 px"
        )
    return _lk_impl(i1, i2, cfg, pyr)


@partial(jax.jit, static_argnames=("cfg", "pyr"))
def _lk_batched_impl(i1, i2, cfg: LKConfig, pyr: PyramidConfig) -> Flow:
    if pyr.warp_radius == 0:
        # vmap turns the auto radius's lax.cond into a select that executes
        # BOTH select loops (pyramid.warp_bilinear_tiled docstring) — pin
        # the exact-for-any-auto-case R=4 under a batch axis instead.
        pyr = dataclasses.replace(pyr, warp_radius=4)
    return jax.vmap(lambda a, b: _lk_pyramid_body(a, b, cfg, pyr))(i1, i2)


@partial(jax.jit, static_argnames=("cfg", "pyr", "mesh"))
def _lk_tiled_impl(i1, i2, cfg: LKConfig, pyr: PyramidConfig, mesh) -> Flow:
    from jax.sharding import NamedSharding, PartitionSpec as P

    spec = NamedSharding(mesh, P("y", "x"))

    def constrain(a):
        return jax.lax.with_sharding_constraint(a, spec)

    return _lk_pyramid_body(constrain(i1), constrain(i2), cfg, pyr, constrain)


def lk_solve_tiled(
    i1: jnp.ndarray,
    i2: jnp.ndarray,
    cfg: LKConfig = LKConfig(),
    pyr: PyramidConfig = PyramidConfig(levels=1, iters_per_level=()),
    mesh=None,
) -> Flow:
    """Spatially tiled LK over a ("y", "x") device mesh (SURVEY.md §2b P2).

    LK has no per-sweep hot loop — each level is a handful of refinements
    dominated by separable window sums and one warp — so the whole pyramid
    distributes as GLOBAL jit ops under `with_sharding_constraint` per
    level: GSPMD inserts the halo collectives for the stencil/window ops
    itself, exactly like the cold per-level ops of dist/pyramid_tiled.py.
    The arithmetic is byte-identical to the untiled path (same functions),
    so tiled == untiled to float tolerance at any mesh shape.
    """
    if i1.ndim != 2:
        raise ValueError("lk_solve_tiled takes single 2-D grayscale frames")
    if i1.shape != i2.shape:
        raise ValueError(f"frame shapes differ: {i1.shape} vs {i2.shape}")
    if mesh is None:
        raise ValueError("lk_solve_tiled requires a mesh (use lk_solve)")
    return _lk_tiled_impl(i1, i2, cfg, pyr, mesh)


def lk_solve_batched(
    i1: jnp.ndarray,
    i2: jnp.ndarray,
    cfg: LKConfig = LKConfig(),
    pyr: PyramidConfig = PyramidConfig(levels=1, iters_per_level=()),
    mesh=None,
) -> Flow:
    """LK over a (B, H, W) stack of frame pairs (vmap inside jit — pure
    data parallelism). With `mesh`, the stack shards over its "batch" axis
    first so GSPMD runs each chip's lanes locally, exactly as batch.py."""
    if i1.ndim != 3:
        raise ValueError(f"expected (B, H, W) frame stacks, got {i1.shape}")
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        sharding = NamedSharding(mesh, P("batch", None, None))
        i1 = jax.device_put(i1, sharding)
        i2 = jax.device_put(i2, sharding)
    return _lk_batched_impl(i1, i2, cfg, pyr)
