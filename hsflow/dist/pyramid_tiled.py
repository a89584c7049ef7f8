"""Mesh-sharded coarse-to-fine pyramid (SURVEY.md §3.3 + §3.5; reference R6
scaled out — the config-5 flagship path).

Division of labor:

  * The cold per-level ops — binomial downsample, bilinear flow upsample,
    backward warp — run ONCE per level, so they stay *global* jit ops under
    `with_sharding_constraint`: GSPMD shards them over the ("y", "x") mesh
    and inserts the halo collectives for the shift stencils itself. Their
    arithmetic is byte-identical to the untiled pyramid (same functions).
  * The hot per-level Jacobi/SOR solve goes through the explicit
    `shard_map` tile body of dist/tiled_solver.py (per-sweep/blockwise
    ppermute halo exchange, per-shard kernel or jnp sweeps, true-edge clamp
    masks) — each level is zero-padded to the mesh grid and cropped back,
    so ANY level geometry works (odd sizes from ceil-halving included).
  * Multigrid/robust levels instead route through a GSPMD level solve
    (_level_solve_gspmd — the same division of labor as
    tiled_solver._tiled_mg_impl): those solvers are pure jnp, and the
    shard_map tile body deliberately has no V-cycle/IRLS branch.

Tiled == untiled therefore holds for the WHOLE pyramid to float tolerance
(asserted at several mesh shapes in tests/distributed/test_pyramid_tiled.py).
`halo_sweeps` is clamped per level so coarse tiles stay valid.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hsflow.config import HSConfig, PyramidConfig
from hsflow.dist.tiled_solver import _round_up, _tile_body
from hsflow.pyramid import gaussian_pyramid, upsample_flow, warp
from hsflow.solver import Flow


def _level_solve_gspmd(
    f1: jnp.ndarray,
    f2: jnp.ndarray,
    cfg: HSConfig,
    mesh: Mesh,
    batched: bool,
) -> Flow:
    """Multigrid/robust level solve: GSPMD global ops (the same division
    of labor as tiled_solver._tiled_mg_impl/_tiled_robust_impl) — both
    solvers are pure jnp, so XLA inserts the halo collectives for every
    stencil and the arithmetic matches the untiled level byte-for-byte up
    to partitioner reassociation. The shard_map tile body deliberately has
    no V-cycle/IRLS branch (its per-sweep halo contract doesn't cover
    inter-grid transfers), so routing a robust/multigrid level through it
    would silently solve plain Jacobi."""
    from hsflow.ops import stencils
    from hsflow.solver import sweeps, sweeps_until

    spec = P("batch", "y", "x") if batched else P("y", "x")
    sh = NamedSharding(mesh, spec)
    a = jax.lax.with_sharding_constraint(f1, sh)
    b = jax.lax.with_sharding_constraint(f2, sh)

    def one(aa, bb):
        ex, ey, et = stencils.derivatives(aa, bb, cfg.deriv_variant)
        inv_den = 1.0 / (cfg.alpha * cfg.alpha + ex * ex + ey * ey)
        u = jnp.zeros_like(ex)
        v = jnp.zeros_like(ex)
        if cfg.tol > 0:
            return sweeps_until(u, v, ex, ey, et, inv_den, cfg)
        return sweeps(u, v, ex, ey, et, inv_den, cfg.iters, cfg)

    flow = (jax.vmap(one) if batched else one)(a, b)
    return Flow(
        jax.lax.with_sharding_constraint(flow.u, sh),
        jax.lax.with_sharding_constraint(flow.v, sh),
    )


def _level_solve(
    f1: jnp.ndarray,
    f2: jnp.ndarray,
    cfg: HSConfig,
    s: int,
    mesh: Mesh,
    batched: bool,
) -> Flow:
    """One level's residual solve: pad to the mesh grid, shard_map the tile
    body (true-edge masks), crop back. Mirrors _tiled_impl for use inside a
    larger jit region."""
    h, w = f1.shape[-2:]
    my, mx = mesh.shape["y"], mesh.shape["x"]
    hp, wp = _round_up(h, my), _round_up(w, mx)
    s = max(1, min(s, hp // my - 1, wp // mx - 1))
    if (hp, wp) != (h, w):
        pad = [(0, 0)] * (f1.ndim - 2) + [(0, hp - h), (0, wp - w)]
        f1 = jnp.pad(f1, pad)
        f2 = jnp.pad(f2, pad)
    spec = P("batch", "y", "x") if batched else P("y", "x")
    body = _tile_body
    if batched:
        body = jax.vmap(_tile_body, in_axes=(0, 0, None, None, None, None))
    fn = jax.shard_map(
        lambda a, b: body(a, b, cfg, s, h, w),
        mesh=mesh,
        in_specs=(spec, spec),
        out_specs=Flow(spec, spec),
        check_vma=False,
    )
    f1 = jax.lax.with_sharding_constraint(f1, NamedSharding(mesh, spec))
    f2 = jax.lax.with_sharding_constraint(f2, NamedSharding(mesh, spec))
    flow = fn(f1, f2)
    if (hp, wp) != (h, w):
        flow = Flow(flow.u[..., :h, :w], flow.v[..., :h, :w])
    return flow


@partial(jax.jit, static_argnames=("cfg", "pyr", "s", "mesh", "batched"))
def _pyramid_tiled_impl(
    i1, i2, cfg: HSConfig, pyr: PyramidConfig, s: int, mesh: Mesh, batched: bool
) -> Flow:
    dtype = jnp.dtype(cfg.dtype)
    spec = P("batch", "y", "x") if batched else P("y", "x")
    sh = NamedSharding(mesh, spec)

    def constrain(a):
        return jax.lax.with_sharding_constraint(a, sh)

    p1 = [constrain(a) for a in gaussian_pyramid(i1.astype(dtype), pyr.levels)]
    p2 = [constrain(a) for a in gaussian_pyramid(i2.astype(dtype), pyr.levels)]
    iters: Sequence[int] = pyr.iters_per_level or (cfg.iters,) * pyr.levels

    flow: Optional[Flow] = None
    for level in range(pyr.levels - 1, -1, -1):
        f1, f2 = p1[level], p2[level]
        if flow is None:
            f2w = f2
        else:
            flow = upsample_flow(flow, f1.shape[-2:])
            flow = Flow(constrain(flow.u), constrain(flow.v))
            f2w = constrain(warp(f2, flow.u, flow.v, pyr.warp))
        lcfg = dataclasses.replace(cfg, iters=iters[level])
        if cfg.solver in ("multigrid", "robust"):
            dflow = _level_solve_gspmd(f1, f2w, lcfg, mesh, batched)
        else:
            dflow = _level_solve(f1, f2w, lcfg, s, mesh, batched)
        if flow is None:
            flow = dflow
        else:
            flow = Flow(flow.u + dflow.u, flow.v + dflow.v)
    return flow


def hs_pyramid_tiled(
    i1: jnp.ndarray,
    i2: jnp.ndarray,
    cfg: HSConfig = HSConfig(),
    pyr: PyramidConfig = PyramidConfig(),
    mesh: Optional[Mesh] = None,
    halo_sweeps: int = 1,
) -> Flow:
    """Coarse-to-fine pyramidal HS with every level sharded over the mesh.

    Accepts (H, W) pairs or (B, H, W) stacks (batch additionally sharded
    over the "batch" axis). Equals hs_pyramid exactly up to the tiled
    solver's float-reassociation tolerance, for any geometry — levels are
    padded to the mesh grid and cropped back internally.
    """
    if mesh is None:
        raise ValueError("hs_pyramid_tiled requires a Mesh (dist.make_mesh)")
    if i1.shape != i2.shape:
        raise ValueError(f"frame shapes differ: {i1.shape} vs {i2.shape}")
    if halo_sweeps < 1:
        raise ValueError("halo_sweeps must be >= 1")
    if cfg.solver == "sor" and cfg.omega == 0.0:
        # omega=0 is the identity update — resolve the auto sentinel here
        # exactly as hs_pyramid does (single pairs), or reject stacks.
        if i1.ndim != 2:
            raise ValueError(
                "omega=0 (auto) is single-pair only — call "
                "solver.tune_omega on a representative pair"
            )
        import dataclasses

        from hsflow.solver import tune_omega

        cfg = dataclasses.replace(cfg, omega=tune_omega(i1, i2, cfg))
    min_side = min(i1.shape[-2:])
    if min_side // (2 ** (pyr.levels - 1)) < 8:
        raise ValueError(
            f"{pyr.levels} levels would shrink a {i1.shape[-2:]} frame below 8 px"
        )
    batched = i1.ndim == 3
    if batched and i1.shape[0] % mesh.shape["batch"]:
        raise ValueError(
            f"batch {i1.shape[0]} not divisible by mesh batch {mesh.shape['batch']}"
        )
    spec = P("batch", None, None) if batched else P(None, None)
    i1 = jax.device_put(i1, NamedSharding(mesh, spec))
    i2 = jax.device_put(i2, NamedSharding(mesh, spec))
    return _pyramid_tiled_impl(i1, i2, cfg, pyr, halo_sweeps, mesh, batched)
