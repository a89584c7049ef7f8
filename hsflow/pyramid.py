"""Coarse-to-fine pyramid + bilinear warping (component N4; reference R6).

SURVEY.md §2.5 (PYR): downsample by a separable 5-tap binomial blur
[1,4,6,4,1]/16 then 2x subsample; from coarsest to finest — solve HS, upsample
flow bilinearly to the next level's size scaling values by the resolution
ratio, backward-warp frame 2 by the current flow (I2w(x,y) = I2(x+u, y+v),
clamped), solve HS on (I1, I2w) for the residual, add.

Warp lowerings (SURVEY.md §7 hard parts): the warp is a dense 2-D gather.
The default is `warp_bilinear_tiled`: one coarse block fetch per (32, 128)
tile at the tile's rounded-mean displacement + an exact local select loop,
exact for the smooth flows HS produces (per-tile deviation <= 4 px) and
clamped gracefully beyond. It was built for hardware whose per-element
gather was slow; the reference gather stays available via
PyramidConfig.warp="gather", and which is faster on the GPU is an open
question (PERF.md).

The whole pyramid is one jit region: the Python level loop unrolls into the
XLA graph (static shapes per level — SURVEY.md §3.3).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp

from hsflow.config import HSConfig, PyramidConfig
from hsflow.solver import Flow, solve_level

# -- 5-tap binomial blur, separable, replicate boundaries --------------------

_B5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def downsample2x(img: jnp.ndarray) -> jnp.ndarray:
    """Blur + 2x subsample. Output spatial size is ceil(size / 2).

    Each separable pass subsamples its own axis immediately after blurring
    it (identical values to blur-then-subsample — the passes are
    independent per axis), halving the second pass's work.
    """
    from hsflow.ops.stencils import (
        shift_down_row,
        shift_left_col,
        shift_right_col,
        shift_up_row,
    )

    r1 = shift_down_row(img)        # i-1
    r2 = shift_down_row(r1)         # i-2
    r3 = shift_up_row(img)          # i+1
    r4 = shift_up_row(r3)           # i+2
    v = _B5[2] * img + _B5[1] * (r1 + r3) + _B5[0] * (r2 + r4)
    v = v[..., ::2, :]
    c1 = shift_right_col(v)
    c2 = shift_right_col(c1)
    c3 = shift_left_col(v)
    c4 = shift_left_col(c3)
    h = _B5[2] * v + _B5[1] * (c1 + c3) + _B5[0] * (c2 + c4)
    return h[..., :, ::2]


def gaussian_pyramid(img: jnp.ndarray, levels: int) -> list[jnp.ndarray]:
    """[finest, ..., coarsest] — levels entries; level 0 is the input."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(downsample2x(pyr[-1]))
    return pyr


# -- flow upsampling and backward warp ----------------------------------------


def upsample_flow(flow: Flow, shape: tuple[int, int]) -> Flow:
    """Bilinearly resize flow to `shape`, scaling values by the size ratio
    per axis (SURVEY.md §2.5 PYR: upsample x2 and multiply values x2).

    jax.image.resize contracts with a dense interpolation matrix; HIGHEST
    precision keeps that product in full fp32 (no TF32 on the GPU)."""
    h0, w0 = flow.u.shape[-2:]
    h1, w1 = shape
    hi = jax.lax.Precision.HIGHEST
    u = jax.image.resize(flow.u, flow.u.shape[:-2] + (h1, w1), method="linear",
                         precision=hi)
    v = jax.image.resize(flow.v, flow.v.shape[:-2] + (h1, w1), method="linear",
                         precision=hi)
    return Flow(u * (w1 / w0), v * (h1 / h0))


def warp_bilinear(img: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Backward warp: out(y, x) = img(y + v(y,x), x + u(y,x)), bilinear,
    sample positions clamped to the image (SURVEY.md §2.5 PYR)."""
    h, w = img.shape[-2:]
    dtype = img.dtype
    yy = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    sy = jnp.clip(yy + v.astype(jnp.float32), 0.0, h - 1.0)
    sx = jnp.clip(xx + u.astype(jnp.float32), 0.0, w - 1.0)
    y0 = jnp.floor(sy)
    x0 = jnp.floor(sx)
    wy = sy - y0
    wx = sx - x0
    y0i = y0.astype(jnp.int32)
    x0i = x0.astype(jnp.int32)
    y1i = jnp.minimum(y0i + 1, h - 1)
    x1i = jnp.minimum(x0i + 1, w - 1)

    flat = img.reshape(img.shape[:-2] + (h * w,))

    def gather(yi, xi):
        idx = yi * w + xi
        if idx.ndim == 2:  # one flow field (shared across any img batch)
            return jnp.take(flat, idx.reshape(-1), axis=-1).reshape(
                img.shape[:-2] + (h, w)
            )
        # batched flow: gather each batch element's own indices
        idx = jnp.broadcast_to(idx, img.shape[:-2] + (h, w))
        idx = idx.reshape(img.shape[:-2] + (h * w,))
        return jnp.take_along_axis(flat, idx, axis=-1).reshape(
            img.shape[:-2] + (h, w)
        )

    p00 = gather(y0i, x0i)
    p01 = gather(y0i, x1i)
    p10 = gather(y1i, x0i)
    p11 = gather(y1i, x1i)
    wy = wy.astype(dtype)
    wx = wx.astype(dtype)
    top = p00 * (1 - wx) + p01 * wx
    bot = p10 * (1 - wx) + p11 * wx
    return top * (1 - wy) + bot * wy


# -- tiled fast warp -----------------------------------------------------------

# Tile geometry for warp_bilinear_tiled: one coarse block fetch per tile plus
# an exact local-offset select loop of half-width R. Exact whenever the
# per-tile deviation of the displacement from its rounded tile mean is <= R
# (HS flows are globally smoothed, so this holds in practice); beyond that
# the sampling position clamps to the reachable window. R is configurable
# (PyramidConfig.warp_radius): the select loop scales as (2R+2-1)^2 — 81
# combos at R=4, 25 at R=2; radius=0 selects R on device from the measured
# per-tile deviation, so the cut is exactness-preserving.
_WARP_TH, _WARP_TW, _WARP_R = 32, 128, 4


def warp_bilinear_tiled(
    img: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray, radius: int = _WARP_R
) -> jnp.ndarray:
    """Tiled backward warp (SURVEY.md §7 'bilinear warp').

    This formulation replaces the 4*H*W scalar fetches of the gather with
    (a) ONE coarse `lax.gather` of a (TH+2R+2, TW+2R+2) block per output
    tile, displaced by the tile's rounded mean flow, and (b) an exact local
    bilinear lookup inside the block via a static-slice select loop —
    (2R+2)^2 fused elementwise ops, no gathers. 2-D only (vmap for batches).

    `radius`: select-loop half-width R. radius=0 = auto — measure the
    per-tile max deviation on device (a cheap reduction over fields the
    formulation already computes) and `lax.cond` between the R=2 and R=4
    select loops: when every tile deviates <= 2 px from its rounded mean
    (the common case for HS-smooth flows) both loops produce bitwise
    identical exact samples, so auto only changes speed, never values.
    Batched callers (vmap) should pass a fixed radius: vmap turns the cond
    into a select that executes BOTH branches.
    """
    h, w = img.shape
    th, tw = _WARP_TH, _WARP_TW
    nh = -(-h // th)
    nw = -(-w // tw)
    hp, wp = nh * th, nw * tw

    # Sample positions are NOT pre-clipped to the image (that would put a
    # steep ramp into the displacement field near the edges and break the
    # per-tile smoothness bound): instead the fetch image is edge-padded, so
    # out-of-range samples read replicated border pixels — the exact same
    # VALUE as position clamping. Positions are only clipped to the padded
    # extent (margin E), beyond which everything replicates anyway.
    e_margin = 64
    yy = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    sy = jnp.clip(yy + v.astype(jnp.float32), -float(e_margin), h - 1.0 + e_margin)
    sx = jnp.clip(xx + u.astype(jnp.float32), -float(e_margin), w - 1.0 + e_margin)
    y0 = jnp.floor(sy)
    x0 = jnp.floor(sx)
    wy = (sy - y0).astype(img.dtype)
    wx = (sx - x0).astype(img.dtype)
    dy = y0 - yy  # integer-valued displacement fields (as float)
    dx = x0 - xx

    def tile4(a):
        # edge-fill so partial tiles' means aren't polluted by padding
        a = jnp.pad(a, ((0, hp - h), (0, wp - w)), mode="edge")
        return a.reshape(nh, th, nw, tw).transpose(0, 2, 1, 3)  # (nh,nw,th,tw)

    dy_t = tile4(dy)
    dx_t = tile4(dx)
    # Rounded per-tile mean displacement -> coarse block offset.
    byt = jnp.round(dy_t.mean(axis=(2, 3))).astype(jnp.int32)  # (nh, nw)
    bxt = jnp.round(dx_t.mean(axis=(2, 3))).astype(jnp.int32)

    def fetch_select(r: int):
        """Coarse block fetch + exact local select loop at half-width r.
        Returns the four bilinear taps in tiled (nh, nw, th, tw) form."""
        k = 2 * r + 2  # local offset range per axis
        # Coarse fetch: block origin = tile origin + mean displacement - R.
        # The image is edge-padded far enough that every block lies fully
        # inside the padded array for any tile-mean target within the
        # clipped position range [-E, size-1+E] (worst-case origin
        # excursion: E + tile/2 + R).
        pad = e_margin + max(th, tw) + k + 2
        imgp = jnp.pad(img, pad, mode="edge")
        oy = jnp.arange(nh, dtype=jnp.int32) * th
        ox = jnp.arange(nw, dtype=jnp.int32) * tw
        start_y = oy[:, None] + byt - r + pad  # into imgp, (nh, nw)
        start_x = ox[None, :] + bxt - r + pad
        starts = jnp.stack(
            [start_y.reshape(-1), start_x.reshape(-1)], axis=-1
        )
        bh, bw = th + k, tw + k
        blocks = jax.lax.gather(
            imgp,
            starts,
            jax.lax.GatherDimensionNumbers(
                offset_dims=(1, 2), collapsed_slice_dims=(),
                start_index_map=(0, 1),
            ),
            slice_sizes=(bh, bw),
            mode=jax.lax.GatherScatterMode.CLIP,
        ).reshape(nh, nw, bh, bw)

        # Local integer offsets inside each block, clamped to the reachable
        # window (exact while the within-tile deviation from the mean is
        # <= R).
        ay = jnp.clip(
            dy_t - byt[:, :, None, None] + r, 0, k - 2
        ).astype(jnp.int32)
        bx = jnp.clip(
            dx_t - bxt[:, :, None, None] + r, 0, k - 2
        ).astype(jnp.int32)
        code = ay * k + bx

        # Column (b) slicing hoisted out of the inner loop: consecutive
        # b-slices are shared via bb/bb1, leaving k column slices plus
        # row slices inside.
        z = jnp.zeros((nh, nw, th, tw), img.dtype)
        p00, p01, p10, p11 = z, z, z, z
        bb = blocks[:, :, :, 0:tw]
        for b in range(k - 1):
            bb1 = blocks[:, :, :, b + 1 : b + 1 + tw]
            for a in range(k - 1):
                m = code == (a * k + b)
                p00 = jnp.where(m, bb[:, :, a : a + th, :], p00)
                p01 = jnp.where(m, bb1[:, :, a : a + th, :], p01)
                p10 = jnp.where(m, bb[:, :, a + 1 : a + 1 + th, :], p10)
                p11 = jnp.where(m, bb1[:, :, a + 1 : a + 1 + th, :], p11)
            bb = bb1
        return p00, p01, p10, p11

    if radius == 0:
        # On-device exactness check: both branches are exact (and bitwise
        # equal) when the within-tile deviation is <= 2; only then is the
        # cheap branch taken, so auto == R=4 in values, always.
        dev = jnp.maximum(
            jnp.abs(dy_t - byt[:, :, None, None].astype(dy_t.dtype)).max(),
            jnp.abs(dx_t - bxt[:, :, None, None].astype(dx_t.dtype)).max(),
        )
        p00, p01, p10, p11 = jax.lax.cond(
            dev <= 2.0,
            lambda: fetch_select(2),
            lambda: fetch_select(_WARP_R),
        )
    else:
        p00, p01, p10, p11 = fetch_select(radius)

    def untile(a):
        return a.transpose(0, 2, 1, 3).reshape(hp, wp)[:h, :w]

    p00, p01, p10, p11 = (untile(p) for p in (p00, p01, p10, p11))
    top = p00 * (1 - wx) + p01 * wx
    bot = p10 * (1 - wx) + p11 * wx
    return top * (1 - wy) + bot * wy


def warp_bilinear_checked(
    img: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray
) -> jnp.ndarray:
    """Exactness-checked warp (round 5): the tiled fast path whenever the
    on-device per-tile deviation proves it exact, else the reference
    gather — a three-way lax.cond over (dev <= 2 -> R=2, dev <= 4 -> R=4,
    else gather). This is what makes the fast warp safe for models whose
    flows BREAK the per-tile smoothness contract (TV-L1's sharp motion
    boundaries): those frames pay the gather price, smooth frames take
    the tiled warp."""
    h, w = img.shape
    th, tw = _WARP_TH, _WARP_TW
    nh = -(-h // th)
    nw = -(-w // tw)
    hp, wp = nh * th, nw * tw
    yy = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    # Deviation of the integer displacement from its rounded per-tile mean
    # — the same fields the tiled warp computes (duplicated here cheaply;
    # XLA CSEs them inside a shared jit when both paths coexist).
    dy = jnp.floor(jnp.clip(yy + v.astype(jnp.float32), -64.0, h + 63.0)) - yy
    dx = jnp.floor(jnp.clip(xx + u.astype(jnp.float32), -64.0, w + 63.0)) - xx

    def tile4(a):
        a = jnp.pad(a, ((0, hp - h), (0, wp - w)), mode="edge")
        return a.reshape(nh, th, nw, tw).transpose(0, 2, 1, 3)

    dy_t = tile4(dy)
    dx_t = tile4(dx)
    byt = jnp.round(dy_t.mean(axis=(2, 3)))
    bxt = jnp.round(dx_t.mean(axis=(2, 3)))
    dev = jnp.maximum(
        jnp.abs(dy_t - byt[:, :, None, None]).max(),
        jnp.abs(dx_t - bxt[:, :, None, None]).max(),
    )
    # Three-way exactness ladder: R=2/4 (the auto pair), then R=8 (289
    # select combos), then the gather. The extra rung matters because dev
    # is a GLOBAL max: one outlier tile (e.g. a TV-L1 edge artifact) would
    # otherwise push the whole frame onto the gather.
    return jax.lax.cond(
        dev <= float(_WARP_R),
        lambda: warp_bilinear_tiled(img, u, v, 0),
        lambda: jax.lax.cond(
            dev <= 8.0,
            lambda: warp_bilinear_tiled(img, u, v, 8),
            lambda: warp_bilinear(img, u, v),
        ),
    )


def warp(
    img: jnp.ndarray,
    u: jnp.ndarray,
    v: jnp.ndarray,
    method: str = "auto",
    radius: int = _WARP_R,
):
    """Dispatch: 'tiled' (exact for smooth flows), 'gather'
    (reference scalar-gather), 'checked' (tiled when provably exact, else
    gather — on-device cond), 'auto' = tiled for 2-D inputs. `radius` is
    the tiled warp's select half-width (0 = on-device auto)."""
    if method == "gather" or img.ndim != 2:
        return warp_bilinear(img, u, v)
    if method == "checked":
        return warp_bilinear_checked(img, u, v)
    return warp_bilinear_tiled(img, u, v, radius)


# -- coarse-to-fine driver -----------------------------------------------------


def _pyramid_body(
    i1: jnp.ndarray,
    i2: jnp.ndarray,
    cfg: HSConfig,
    pyr: PyramidConfig,
) -> Flow:
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
            f2w = warp(f2, flow.u, flow.v, pyr.warp, pyr.warp_radius)
        # Each level is a zero-init residual solve through solve_level
        # (tol handling lives there too: per-level early stopping with
        # budget=iters[level]).
        dflow = solve_level(f1, f2w, cfg, iters[level])
        if flow is None:
            flow = dflow
        else:
            flow = Flow(flow.u + dflow.u, flow.v + dflow.v)
    return flow


@partial(jax.jit, static_argnames=("cfg", "pyr"))
def _hs_pyramid_impl(i1, i2, cfg: HSConfig, pyr: PyramidConfig) -> Flow:
    return _pyramid_body(i1, i2, cfg, pyr)


def hs_pyramid(
    i1: jnp.ndarray,
    i2: jnp.ndarray,
    cfg: HSConfig = HSConfig(),
    pyr: PyramidConfig = PyramidConfig(),
) -> Flow:
    """Coarse-to-fine pyramidal Horn-Schunck (driver config 3; reference R6).

    With pyr.levels == 1 this is exactly hs_solve.
    """
    if i1.shape != i2.shape:
        raise ValueError(f"frame shapes differ: {i1.shape} vs {i2.shape}")
    min_side = min(i1.shape[-2:])
    if min_side // (2 ** (pyr.levels - 1)) < 8:
        raise ValueError(
            f"{pyr.levels} levels would shrink a {i1.shape[-2:]} frame below 8 px"
        )
    if cfg.solver == "sor" and cfg.omega == 0.0:
        # Auto-omega from the full-resolution problem (coarser levels are
        # easier — better conditioned — so this is a safe upper bound).
        import dataclasses

        from hsflow.solver import tune_omega

        cfg = dataclasses.replace(cfg, omega=tune_omega(i1, i2, cfg))
    return _hs_pyramid_impl(i1, i2, cfg, pyr)
