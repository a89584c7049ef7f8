"""Forward-backward consistency and occlusion masks.

A capability the reference app class stops short of (SURVEY.md §2a ends at
R8 visualization) but that production flow consumers need: a flow vector is
trustworthy only where the backward flow, sampled at the forward target,
cancels it. Occlusion = the standard Sundaram/Brox-style test

    |f_fwd(x) + f_bwd(x + f_fwd(x))|^2  >  a*(|f_fwd(x)|^2
                                            + |f_bwd(x + f_fwd(x))|^2) + b

with (a, b) = (0.01, 0.5) defaults.

Shape: BOTH directions solve in ONE batched call — the stack
[(i1, i2), (i2, i1)] is one batched solve (batch.py), so
fwd+bwd costs one solve's wall-clock at batch 2, not two solves. The
compose step is two bilinear warps (pyramid.warp, the once-per-solve gather
class — never in the sweep loop, SURVEY.md §7 hard-parts note).
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from hsflow.batch import hs_solve_batched
from hsflow.config import HSConfig, LKConfig, PyramidConfig, TVL1Config
from hsflow.pyramid import warp
from hsflow.solver import Flow


def _warped_backward(fwd: Flow, bwd: Flow, method: str):
    """The two bilinear warps (the only expensive ops here): backward flow
    sampled at the forward targets. Shared by fb_error/occlusion_mask so
    combined callers pay 2 warps, not 4 (under jit XLA CSEs them anyway)."""
    bu = warp(bwd.u, fwd.u, fwd.v, method)
    bv = warp(bwd.v, fwd.u, fwd.v, method)
    return bu, bv


def fb_error(fwd: Flow, bwd: Flow, method: str = "gather") -> jnp.ndarray:
    """|f_fwd(x) + f_bwd(x + f_fwd(x))| per pixel (H, W).

    `method` follows pyramid.warp ("gather" default: correct for arbitrary
    flows; "tiled" is faster for smooth flows)."""
    bu, bv = _warped_backward(fwd, bwd, method)
    return jnp.sqrt((fwd.u + bu) ** 2 + (fwd.v + bv) ** 2)


def occlusion_mask(
    fwd: Flow,
    bwd: Flow,
    a: float = 0.01,
    b: float = 0.5,
    method: str = "gather",
) -> jnp.ndarray:
    """Boolean (H, W): True where the forward flow FAILS the
    forward-backward test — occluded or unreliable pixels."""
    bu, bv = _warped_backward(fwd, bwd, method)
    err2 = (fwd.u + bu) ** 2 + (fwd.v + bv) ** 2
    mag2 = fwd.u**2 + fwd.v**2 + bu**2 + bv**2
    return err2 > a * mag2 + b


def solve_bidirectional(
    i1: jnp.ndarray,
    i2: jnp.ndarray,
    cfg: HSConfig = HSConfig(),
    pyr: Optional[PyramidConfig] = None,
    lk: Optional[LKConfig] = None,
    tvl1: Optional[TVL1Config] = None,
    mesh=None,
    halo_sweeps: int = 1,
) -> tuple[Flow, Flow]:
    """(forward, backward) flow for one pair via a single batch-2 solve
    (both directions share every kernel launch).

    The consistency test is model-agnostic: pass `lk=`/`tvl1=` to run the
    Lucas-Kanade or TV-L1 family instead of HS (`cfg` is then ignored).
    `mesh`: additionally shard the solve over a ("batch","y","x") device
    mesh — the HS leg rides ONE batch-2 tiled pyramid solve (blockwise
    ppermute halos); LK/TV-L1 run their GSPMD-constrained tiled solve once
    per direction (the second call hits the same jit cache).
    """
    if i1.ndim != 2:
        raise ValueError(f"expected (H, W) frames, got {i1.shape}")
    if lk is not None and tvl1 is not None:
        raise ValueError("pass at most one of lk= and tvl1=")
    b1 = jnp.stack([i1, i2])
    b2 = jnp.stack([i2, i1])
    alt_pyr = pyr if pyr is not None else PyramidConfig(
        levels=1, iters_per_level=()
    )
    spatial = mesh is not None and (
        mesh.shape.get("y", 1) * mesh.shape.get("x", 1) > 1
    )
    if lk is not None:
        from hsflow.lucas_kanade import lk_solve_batched, lk_solve_tiled

        if spatial:
            fu = lk_solve_tiled(i1, i2, lk, alt_pyr, mesh=mesh)
            bw = lk_solve_tiled(i2, i1, lk, alt_pyr, mesh=mesh)
            return fu, bw
        f = lk_solve_batched(b1, b2, lk, alt_pyr, mesh=mesh)
    elif tvl1 is not None:
        from hsflow.tvl1 import tvl1_solve_batched, tvl1_solve_tiled

        if spatial:
            fu = tvl1_solve_tiled(i1, i2, tvl1, alt_pyr, mesh=mesh)
            bw = tvl1_solve_tiled(i2, i1, tvl1, alt_pyr, mesh=mesh)
            return fu, bw
        f = tvl1_solve_batched(b1, b2, tvl1, alt_pyr, mesh=mesh)
    else:
        if cfg.solver == "sor" and cfg.omega == 0.0:
            # Semantically a single pair: resolve the auto-omega sentinel here
            # (the batched entry's single-pair-only guard would reject it).
            import dataclasses

            from hsflow.solver import tune_omega

            cfg = dataclasses.replace(cfg, omega=tune_omega(i1, i2, cfg))
        if spatial:
            # Batch-2 over the FULL ("batch","y","x") mesh: both directions
            # ride the mesh-sharded pyramid (a 1-level pyramid is exactly
            # the tiled solve), tiled == untiled by Jacobi order-independence.
            from hsflow.dist import hs_pyramid_tiled

            f = hs_pyramid_tiled(
                b1, b2, cfg, alt_pyr, mesh=mesh, halo_sweeps=halo_sweeps
            )
        else:
            f = hs_solve_batched(b1, b2, cfg, pyr, mesh=mesh)
    return Flow(f.u[0], f.v[0]), Flow(f.u[1], f.v[1])


def flow_with_occlusion(
    i1: jnp.ndarray,
    i2: jnp.ndarray,
    cfg: HSConfig = HSConfig(),
    pyr: Optional[PyramidConfig] = None,
    a: float = 0.01,
    b: float = 0.5,
    lk: Optional[LKConfig] = None,
    tvl1: Optional[TVL1Config] = None,
    mesh=None,
    halo_sweeps: int = 1,
) -> tuple[Flow, jnp.ndarray]:
    """Forward flow plus its occlusion mask, one call (any model family,
    optionally mesh-sharded — see solve_bidirectional)."""
    fwd, bwd = solve_bidirectional(
        i1, i2, cfg, pyr, lk=lk, tvl1=tvl1, mesh=mesh, halo_sweeps=halo_sweeps
    )
    return fwd, occlusion_mask(fwd, bwd, a=a, b=b)
