"""Tiled multi-chip Horn-Schunck solve (component N7; SURVEY.md §3.5).

`shard_map` over a ("batch", "y", "x") mesh: each chip owns an image tile;
every halo block is 4 ppermutes (±y, ±x — two-phase, corners included) and s
local Jacobi sweeps. Jacobi's order-independence makes the tiled solve
*exactly* equivalent to the untiled one given correct halos (SURVEY.md §2.5)
— that invariant is asserted by tests/distributed/ at several mesh shapes.

Arbitrary H x W: frames are zero-padded up to the mesh grid and every tile
body clamps at the TRUE image edges via boolean masks from global
coordinates (ops.stencils masked twins of the solver ops; the GPU tile
kernel uses the same scheme) — pad values are garbage that true pixels never
read, and the output is cropped back. No silent geometry changes on user
data.

Blockwise halo (halo_sweeps = s > 1) exchanges an s-px halo every s sweeps to
amortize ppermute latency (NCCL over NVLink between the cards of one host):
the halo ring decays one ring per sweep while the owned tile stays exact
(ring-attention-style blocking,
SURVEY.md §2b P4). Derivatives are computed once from frames exchanged with
an (s+1)-px halo — the +1 feeds the 2x2x2 forward-difference cube (§2.5 D).

Multi-process: the same code runs under `jax.distributed.initialize()` —
see dist/multihost.py.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hsflow.config import HSConfig
from hsflow.dist.halo import halo_pad, unpad
from hsflow.ops import stencils
from hsflow.solver import Flow, resolve_backend


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _tile_masks(row0, col0, shape, h: int, w: int):
    """True-edge clamp masks for a tile whose top-left (halo included) sits
    at traced global coordinates (row0, col0) of the h x w image."""
    gr = row0 + lax.broadcasted_iota(jnp.int32, shape, 0)
    gc = col0 + lax.broadcasted_iota(jnp.int32, shape, 1)
    return stencils.edge_masks(gr, gc, h, w)


def _tile_body(
    i1t: jnp.ndarray, i2t: jnp.ndarray, cfg: HSConfig, s: int, h: int, w: int
) -> Flow:
    """Per-chip solve body; runs inside shard_map with y/x axes bound.

    (h, w) is the TRUE image size; the sharded array may be zero-padded
    beyond it and tiles clamp at the true edges via masks.
    """
    dtype = jnp.dtype(cfg.dtype)
    i1t = i1t.astype(dtype)
    i2t = i2t.astype(dtype)
    th, tw = i1t.shape
    row0 = lax.axis_index("y") * th
    col0 = lax.axis_index("x") * tw
    is_sor = cfg.solver == "sor"
    # Halo width per exchange block: Jacobi's halo decays one ring per
    # SWEEP; SOR's decays one ring per COLOR STAGE (a stage reads pixels
    # updated this sweep), so s sweeps need a 4*s-px halo (4 colors/sweep).
    hw = 4 * s if is_sor else s
    # Frames with (hw+1)-px halo -> derivatives exact on the hw-halo region.
    f1 = halo_pad(i1t, hw + 1)
    f2 = halo_pad(i2t, hw + 1)
    dmasks = _tile_masks(row0 - (hw + 1), col0 - (hw + 1), f1.shape, h, w)
    ex, ey, et = stencils.derivatives_masked(f1, f2, dmasks, cfg.deriv_variant)
    ex, ey, et = (unpad(a, 1) for a in (ex, ey, et))
    invd = 1.0 / (cfg.alpha * cfg.alpha + ex * ex + ey * ey)

    u = jnp.zeros_like(i1t)
    v = jnp.zeros_like(i1t)
    use_pallas = resolve_backend(cfg.backend) == "pallas" and not is_sor
    if use_pallas:
        from hsflow.kernels.jacobi import tile_sweeps
    else:
        pshape = (th + 2 * hw, tw + 2 * hw)
        smasks = _tile_masks(row0 - hw, col0 - hw, pshape, h, w)
        if is_sor:
            # Colors keyed by GLOBAL parity — a tile whose offset is odd
            # flips local parity (stencils.sor_step_masked docstring).
            gr = row0 - hw + lax.broadcasted_iota(jnp.int32, pshape, 0)
            gc = col0 - hw + lax.broadcasted_iota(jnp.int32, pshape, 1)
            colors = tuple(
                (gr % 2 == pi) & (gc % 2 == pj)
                for pi in (0, 1) for pj in (0, 1)
            )

    def block(uv, n_sweeps):
        uu = halo_pad(uv[0], hw)
        vv = halo_pad(uv[1], hw)
        if use_pallas:
            # Per-device kernel sweeps; the clamp fires at true global edges
            # via the tile's traced global offset (SURVEY.md §3.5 hot loop).
            uu, vv = tile_sweeps(
                uu, vv, ex, ey, et, invd, n_sweeps,
                row0 - hw, col0 - hw, h, w,
            )
        else:
            if is_sor:
                def body(_, x):
                    return stencils.sor_step_masked(
                        x[0], x[1], ex, ey, et, invd, cfg.omega, colors,
                        smasks,
                    )
            else:
                def body(_, x):
                    return stencils.jacobi_step_masked(
                        x[0], x[1], ex, ey, et, invd, smasks
                    )

            uu, vv = lax.fori_loop(0, n_sweeps, body, (uu, vv))
        return unpad(uu, hw), unpad(vv, hw)

    if cfg.tol > 0:
        # Distributed solve-to-tolerance: after each s-sweep halo block,
        # every shard takes the max |update| over its OWNED true pixels
        # (pad garbage masked out) and a pmax over the mesh makes the stop
        # decision globally uniform — one lax.while_loop, no host sync.
        # Budget cap = cfg.iters rounded DOWN to whole blocks, mirroring
        # solver.sweeps_until. The check block shrinks to the budget when
        # iters < s (the halo width stays sized for s — wider than a short
        # block needs, which is harmless, same as the fixed path's
        # remainder block).
        b = max(1, min(s, cfg.iters))
        vmask = (
            (row0 + lax.broadcasted_iota(jnp.int32, (th, tw), 0) < h)
            & (col0 + lax.broadcasted_iota(jnp.int32, (th, tw), 1) < w)
        )
        big = jnp.asarray(jnp.finfo(dtype).max, dtype)

        def cond(st):
            _, _, k, delta = st
            return jnp.logical_and(k + b <= cfg.iters, delta > cfg.tol)

        def step(st):
            uu, vv, k, _ = st
            nu, nv = block((uu, vv), b)
            d = jnp.maximum(
                jnp.where(vmask, jnp.abs(nu - uu), 0).max(),
                jnp.where(vmask, jnp.abs(nv - vv), 0).max(),
            )
            d = lax.pmax(lax.pmax(d, "y"), "x")
            return (nu, nv, k + b, d)

        u, v, _, _ = lax.while_loop(cond, step, (u, v, jnp.int32(0), big))
        return Flow(u, v)

    n_full, rem = divmod(cfg.iters, s)
    if n_full > 0:
        u, v = lax.fori_loop(
            0, n_full, lambda _, uv: block(uv, s), (u, v)
        )
    if rem > 0:
        u, v = block((u, v), rem)
    return Flow(u, v)


@partial(jax.jit, static_argnames=("cfg", "mesh", "batched"))
def _tiled_mg_impl(i1, i2, cfg: HSConfig, mesh: Mesh,
                   batched: bool = False) -> Flow:
    """Mesh-sharded multigrid: the V-cycle runs as GLOBAL jit ops under
    GSPMD sharding constraints — same arithmetic as the single-device
    cycle up to partitioner reassociation (tiled == untiled to ~2e-6,
    tested), with XLA inserting the halo collectives for every
    smoothing/restriction/prolongation stencil. The division of labor:
    multigrid does FEW sweeps over many
    small grids (coarse levels may even be replicated by the partitioner,
    which is the right call at that size), so compiler-scheduled halos
    beat hand-rolled blockwise ppermute here — the opposite tradeoff from
    the many-sweep Jacobi/SOR tile bodies. (B, H, W) stacks vmap the
    cycle with the batch axis additionally sharded over "batch"."""
    from hsflow.multigrid import mg_solve

    spec = P("batch", "y", "x") if batched else P("y", "x")
    sh = NamedSharding(mesh, spec)
    dtype = jnp.dtype(cfg.dtype)
    a = lax.with_sharding_constraint(i1.astype(dtype), sh)
    b = lax.with_sharding_constraint(i2.astype(dtype), sh)

    def one(aa, bb):
        ex, ey, et = stencils.derivatives(aa, bb, cfg.deriv_variant)
        u = jnp.zeros_like(ex)
        v = jnp.zeros_like(ex)
        if cfg.tol > 0:
            from hsflow.solver import sweeps_until

            return sweeps_until(
                u, v, ex, ey, et, ex, cfg,  # inv_den unused by the override
                run_block=lambda uu, vv, nn: mg_solve(
                    uu, vv, ex, ey, et, cfg.alpha, nn
                ),
            )
        return Flow(*mg_solve(u, v, ex, ey, et, cfg.alpha, cfg.iters))

    flow = (jax.vmap(one) if batched else one)(a, b)
    return Flow(
        lax.with_sharding_constraint(flow.u, sh),
        lax.with_sharding_constraint(flow.v, sh),
    )


@partial(jax.jit, static_argnames=("cfg", "mesh", "batched"))
def _tiled_robust_impl(i1, i2, cfg: HSConfig, mesh: Mesh,
                       batched: bool = False) -> Flow:
    """Mesh-sharded Charbonnier IRLS (solver="robust"): GSPMD route, same
    division of labor as _tiled_mg_impl — the sweep is elementwise + 4
    shifts and the weight refreezes are global passes, so compiler-
    scheduled halo collectives under sharding constraints reproduce the
    single-device arithmetic exactly (robust.py is pure jnp). (B, H, W)
    stacks vmap with the batch axis additionally sharded over "batch"."""
    from hsflow.robust import robust_sweeps

    spec = P("batch", "y", "x") if batched else P("y", "x")
    sh = NamedSharding(mesh, spec)
    dtype = jnp.dtype(cfg.dtype)
    a = lax.with_sharding_constraint(i1.astype(dtype), sh)
    b = lax.with_sharding_constraint(i2.astype(dtype), sh)

    def one(aa, bb):
        ex, ey, et = stencils.derivatives(aa, bb, cfg.deriv_variant)
        u = jnp.zeros_like(ex)
        v = jnp.zeros_like(ex)
        if cfg.tol > 0:
            from hsflow.solver import sweeps_until

            return sweeps_until(
                u, v, ex, ey, et, ex, cfg,  # inv_den unused by the override
                run_block=lambda uu, vv, nn: robust_sweeps(
                    uu, vv, ex, ey, et, nn, cfg
                ),
            )
        return Flow(*robust_sweeps(u, v, ex, ey, et, cfg.iters, cfg))

    flow = (jax.vmap(one) if batched else one)(a, b)
    return Flow(
        lax.with_sharding_constraint(flow.u, sh),
        lax.with_sharding_constraint(flow.v, sh),
    )


@partial(jax.jit, static_argnames=("cfg", "s", "mesh", "batched", "h", "w"))
def _tiled_impl(i1, i2, cfg: HSConfig, s: int, mesh: Mesh, batched: bool,
                h: int, w: int):
    spec = P("batch", "y", "x") if batched else P("y", "x")
    body = _tile_body
    if batched:
        body = jax.vmap(body, in_axes=(0, 0, None, None, None, None))
    fn = jax.shard_map(
        lambda a, b: body(a, b, cfg, s, h, w),
        mesh=mesh,
        in_specs=(spec, spec),
        out_specs=Flow(spec, spec),
        # pallas_call outputs carry no varying-mesh-axes metadata; skip the
        # vma check (correctness is asserted by the tiled==untiled tests).
        check_vma=False,
    )
    return fn(i1, i2)


def hs_solve_tiled(
    i1: jnp.ndarray,
    i2: jnp.ndarray,
    cfg: HSConfig = HSConfig(),
    mesh: Optional[Mesh] = None,
    halo_sweeps: int = 1,
) -> Flow:
    """Solve HS flow with the image tiled over mesh axes ("y", "x").

    Accepts (H, W) single pairs or (B, H, W) stacks; stacks are additionally
    sharded over the "batch" axis (DP x TP composition, SURVEY.md §2b).
    Any H x W works: frames are zero-padded to the mesh grid internally,
    tiles clamp at the true image edges via masks, and the flow is cropped
    back to H x W — exactly equal to the untiled solve. Tiles (after
    padding) must be at least halo_sweeps+1 pixels on a side. Halos move
    by `ppermute` between kernel (or jnp) sweep blocks.

    cfg.solver="sor" tiles too (jnp body; colors keyed by global parity):
    each exchange block moves a 4*halo_sweeps-px halo because the
    Gauss-Seidel halo decays one ring per color stage, still O(perimeter)
    traffic for the usual 8x fewer sweeps.

    cfg.tol > 0 enables distributed solve-to-tolerance: each halo block's
    max |update| over owned true pixels is pmax-reduced over the mesh, so
    every shard stops at the same block — entirely on-device (no host
    sync), budget = cfg.iters rounded down to whole blocks, identical
    stopping point to solver.sweeps_until when block cadences match. For
    (B, H, W) stacks the stop is global over the batch (vmapped
    while_loop runs until the slowest element converges).
    """
    if mesh is None:
        raise ValueError("hs_solve_tiled requires a Mesh (dist.make_mesh)")
    if halo_sweeps < 1:
        raise ValueError("halo_sweeps must be >= 1")
    if cfg.solver in ("multigrid", "robust"):
        # GSPMD route: the whole V-cycle / IRLS loop as global sharded jit
        # ops (exact same arithmetic as single-device; XLA schedules the
        # halos). (B, H, W) stacks vmap with the batch axis sharded too.
        # No pre-sharded device_put: with_sharding_constraint inside the
        # jit accepts uneven (odd H x W) shardings, device_put does not.
        impl = (_tiled_mg_impl if cfg.solver == "multigrid"
                else _tiled_robust_impl)
        return impl(i1, i2, cfg, mesh, batched=i1.ndim == 3)
    if cfg.solver == "sor" and cfg.omega == 0.0:
        raise ValueError(
            "omega=0 (auto) is single-pair only — call solver.tune_omega on "
            "a representative pair and pass the result"
        )
    batched = i1.ndim == 3
    h, w = i1.shape[-2:]
    my = mesh.shape["y"]
    mx = mesh.shape["x"]
    if batched and i1.shape[0] % mesh.shape["batch"]:
        raise ValueError(
            f"batch {i1.shape[0]} not divisible by mesh batch {mesh.shape['batch']}"
        )
    hp, wp = _round_up(h, my), _round_up(w, mx)
    # SOR halos are 4x wider per block (one decay ring per color stage).
    hwidth = 4 * halo_sweeps if cfg.solver == "sor" else halo_sweeps
    if hp // my <= hwidth or wp // mx <= hwidth:
        raise ValueError(
            f"tile {hp // my}x{wp // mx} too small for halo_sweeps="
            f"{halo_sweeps} (solver={cfg.solver}, halo width {hwidth})"
        )
    if (hp, wp) != (h, w):
        pad = [(0, 0)] * (i1.ndim - 2) + [(0, hp - h), (0, wp - w)]
        i1 = jnp.pad(i1, pad)
        i2 = jnp.pad(i2, pad)
    spec = P("batch", "y", "x") if batched else P("y", "x")
    sharding = NamedSharding(mesh, spec)
    i1 = jax.device_put(i1, sharding)
    i2 = jax.device_put(i2, sharding)
    flow = _tiled_impl(i1, i2, cfg, halo_sweeps, mesh, batched, h, w)
    if (hp, wp) != (h, w):
        flow = Flow(flow.u[..., :h, :w], flow.v[..., :h, :w])
    return flow
