"""Batched / data-parallel flow over frame pairs (component N6; SURVEY.md §2b P1).

Driver config 2: batched HS over a video sequence. The batch axis is pure
data parallelism — no cross-shard communication during the solve — realized
as `vmap` inside jit, optionally laid out over the "batch" mesh axis with a
`NamedSharding` so XLA runs each chip's sub-batch locally (SURVEY.md §3.4).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hsflow.config import HSConfig, PyramidConfig
from hsflow.pyramid import _pyramid_body
from hsflow.solver import Flow, precompute, sweeps, sweeps_until


def solve_level_batched(
    i1: jnp.ndarray,
    i2: jnp.ndarray,
    cfg: HSConfig,
    iters: int,
    stacked_ok: bool = True,
) -> Flow:
    """One fixed-budget zero-init solve on a (B, H, W) stack — the batch
    twin of solver.solve_level, shared by `_batched_solve_impl` and the
    batched pyramid's level solves.

    On the kernel backend the stack is one kernel launch per pass, with
    the batch as a grid axis (the derivative stencils are batch-aware), and
    solve-to-tolerance stops on the max update over the whole stack.
    Otherwise, and for mesh-sharded stacks (stacked_ok=False), the
    single-pair solve is vmapped: GSPMD splits the vmap lanes per device
    with zero collectives.
    """
    from hsflow.solver import resolve_backend

    def single(a, b):
        ex, ey, et, inv_den = precompute(a, b, cfg)
        u = jnp.zeros_like(ex)
        v = jnp.zeros_like(ex)
        if cfg.tol > 0:
            return sweeps_until(u, v, ex, ey, et, inv_den, cfg, budget=iters)
        return sweeps(u, v, ex, ey, et, inv_den, iters, cfg)

    if (
        stacked_ok
        and cfg.solver == "jacobi"
        and resolve_backend(cfg.backend) == "pallas"
    ):
        return single(i1, i2)
    return jax.vmap(single)(i1, i2)


@partial(jax.jit, static_argnames=("cfg", "stacked_ok"))
def _batched_solve_impl(
    i1: jnp.ndarray, i2: jnp.ndarray, cfg: HSConfig, stacked_ok: bool = True
) -> Flow:
    return solve_level_batched(i1, i2, cfg, cfg.iters, stacked_ok)


@partial(jax.jit, static_argnames=("cfg", "pyr", "stacked_ok"))
def _batched_pyramid_impl(
    i1, i2, cfg: HSConfig, pyr: PyramidConfig, stacked_ok: bool = True
) -> Flow:
    from typing import Optional, Sequence

    from hsflow.pyramid import (
        gaussian_pyramid,
        upsample_flow,
        warp_bilinear,
        warp_bilinear_tiled,
    )
    from hsflow.solver import resolve_backend

    if not (
        stacked_ok
        and cfg.solver == "jacobi"
        and resolve_backend(cfg.backend) == "pallas"
    ):
        # Mesh-sharded stacks and non-Jacobi solvers: vmap the single-pair
        # body (GSPMD splits the lanes per device).
        return jax.vmap(lambda a, b: _pyramid_body(a, b, cfg, pyr))(i1, i2)

    # Batch-aware pyramid body: the per-level ops are batch-aware jnp, and
    # each level's zero-init residual solve is one batched kernel solve
    # (solve_level_batched) per level instead of one per frame.
    dtype = jnp.dtype(cfg.dtype)
    p1 = gaussian_pyramid(i1.astype(dtype), pyr.levels)
    p2 = gaussian_pyramid(i2.astype(dtype), pyr.levels)
    iters: Sequence[int] = pyr.iters_per_level or (cfg.iters,) * pyr.levels

    flow: Optional[Flow] = None
    for level in range(pyr.levels - 1, -1, -1):
        f1, f2 = p1[level], p2[level]
        if flow is None:
            f2w = f2
        else:
            flow = upsample_flow(flow, f1.shape[-2:])
            if pyr.warp == "gather":
                f2w = warp_bilinear(f2, flow.u, flow.v)
            else:
                f2w = jax.vmap(warp_bilinear_tiled)(f2, flow.u, flow.v)
        dflow = solve_level_batched(f1, f2w, cfg, iters[level], stacked_ok)
        if flow is None:
            flow = dflow
        else:
            flow = Flow(flow.u + dflow.u, flow.v + dflow.v)
    return flow


def hs_solve_batched(
    i1: jnp.ndarray,
    i2: jnp.ndarray,
    cfg: HSConfig = HSConfig(),
    pyr: Optional[PyramidConfig] = None,
    mesh: Optional[Mesh] = None,
) -> Flow:
    """Solve flow for a (B, H, W) stack of frame pairs.

    With `mesh`, inputs are sharded P("batch", None, None) across its "batch"
    axis before the jitted solve — XLA then executes each shard's vmap lanes
    with zero collectives (SURVEY.md §2b P1).
    """
    if i1.ndim != 3:
        raise ValueError(f"expected (B, H, W) frame stacks, got {i1.shape}")
    if cfg.solver == "sor" and cfg.omega == 0.0:
        raise ValueError(
            "omega=0 (auto) is single-pair only — call solver.tune_omega on "
            "a representative pair and pass the result"
        )
    if mesh is not None:
        sharding = NamedSharding(mesh, P("batch", None, None))
        i1 = jax.device_put(i1, sharding)
        i2 = jax.device_put(i2, sharding)
    if pyr is not None and pyr.levels > 1:
        return _batched_pyramid_impl(i1, i2, cfg, pyr, stacked_ok=mesh is None)
    return _batched_solve_impl(i1, i2, cfg, stacked_ok=mesh is None)


def video_pairs(frames: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(T, H, W) video -> ((T-1, H, W), (T-1, H, W)) consecutive frame pairs."""
    if frames.ndim != 3:
        raise ValueError(f"expected (T, H, W) video, got {frames.shape}")
    return frames[:-1], frames[1:]
