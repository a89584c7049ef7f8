"""Streaming video flow, double-buffered (component N8; driver config 4).

The reference is a one-shot two-frame app (SURVEY.md §1a); video streaming
is mandated by the north star (config 4: HD streaming, real-time frames/s).
Pipeline-parallel structure (SURVEY.md §2b P6): frames arrive host-side in
chunks; while chunk k's solve executes on-device, chunk k+1's host->HBM DMA
is already in flight — realized through JAX's async dispatch by issuing the
device_put for the next chunk *before* blocking on the current chunk's
result. Chunks overlap by one frame so the pair stream is seamless.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from hsflow.batch import hs_solve_batched
from hsflow.config import HSConfig, LKConfig, PyramidConfig, TVL1Config
from hsflow.solver import Flow


def _chunked_with_overlap(frames: Iterable[np.ndarray], chunk: int):
    """Yield (chunk+1)-frame windows overlapping by one frame."""
    buf: list[np.ndarray] = []
    for f in frames:
        buf.append(np.asarray(f))
        if len(buf) == chunk + 1:
            yield np.stack(buf)
            buf = buf[-1:]
    if len(buf) >= 2:
        yield np.stack(buf)


def _prefetched_windows(
    frames: Union[np.ndarray, Iterable[np.ndarray]], chunk: int
) -> Iterator[jnp.ndarray]:
    """The P6 pipeline core, shared by every stream variant: yield device-
    resident (chunk+1)-frame windows, issuing the NEXT window's host->HBM
    transfer before the current one is consumed so async dispatch overlaps
    it with the consumer's solve."""
    if chunk < 1:
        raise ValueError("chunk must be >= 1")
    if isinstance(frames, (np.ndarray, jnp.ndarray)):
        if frames.ndim != 3:
            raise ValueError(f"expected (T, H, W) video, got {frames.shape}")
        frames = iter(frames)

    windows = _chunked_with_overlap(frames, chunk)
    nxt = next(windows, None)
    dev_next = jax.device_put(nxt) if nxt is not None else None
    while dev_next is not None:
        cur = dev_next
        nxt = next(windows, None)
        dev_next = jax.device_put(nxt) if nxt is not None else None
        yield cur


def flow_stream(
    frames: Union[np.ndarray, Iterable[np.ndarray]],
    cfg: HSConfig = HSConfig(),
    pyr: Optional[PyramidConfig] = None,
    chunk: int = 8,
    mesh=None,
    lk: Optional[LKConfig] = None,
    tvl1: Optional[TVL1Config] = None,
) -> Iterator[Flow]:
    """Stream dense flow over a video, yielding one batched Flow per chunk.

    `frames`: (T, H, W) array or an iterator of (H, W) frames (the iterator
    form is what a camera/decoder feed looks like). Yields Flow with leading
    axis = pairs in the chunk; results are device arrays — the consumer
    chooses when to sync, keeping the pipeline free-running.

    `mesh`: shard each chunk's pairs over the mesh "batch" axis (DP
    streaming, SURVEY.md §2b P1 x P6; chunk must be divisible by the
    mesh's batch size).

    `lk` / `tvl1`: solve with the Lucas-Kanade or TV-L1 family instead of HS
    (`cfg` is then ignored); the prefetch pipeline and sharding are identical.
    """
    if lk is not None and tvl1 is not None:
        raise ValueError("pass at most one of lk= and tvl1=")
    alt_pyr = None
    if lk is not None or tvl1 is not None:
        alt_pyr = pyr if pyr is not None else PyramidConfig(
            levels=1, iters_per_level=()
        )
    if lk is not None:
        from hsflow.lucas_kanade import lk_solve_batched
    if tvl1 is not None:
        from hsflow.tvl1 import tvl1_solve_batched
    for cur in _prefetched_windows(frames, chunk):
        # The stream's final (remainder) chunk may not divide the mesh's
        # batch axis — run it unsharded rather than erroring at stream end.
        m = mesh
        if m is not None and (cur.shape[0] - 1) % m.shape["batch"]:
            m = None
        if lk is not None:
            yield lk_solve_batched(cur[:-1], cur[1:], lk, alt_pyr, mesh=m)
        elif tvl1 is not None:
            yield tvl1_solve_batched(cur[:-1], cur[1:], tvl1, alt_pyr, mesh=m)
        else:
            yield hs_solve_batched(cur[:-1], cur[1:], cfg, pyr, mesh=m)


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("cfg", "warm_scale", "warp_prior"))
def _warm_scan(pairs1, pairs2, u0, v0, cfg: HSConfig, warm_scale: float,
               warp_prior: bool):
    """K dependent warm-started solves in ONE jit region: a lax.scan over
    the window's pairs with the flow as the carry, so the whole chain costs
    one dispatch instead of K. (The seed u0/v0 is NOT donated: it is the
    previous window's yielded flow, which the stream consumer may still
    hold.) The scan body is exactly the per-pair arithmetic
    (solver.solve_level with the warm start as u0/v0), traced once."""
    from jax import lax

    from hsflow.solver import solve_level

    def body(carry, xs):
        u, v = carry
        f1, f2 = xs
        bu, bv = u * warm_scale, v * warm_scale
        if warp_prior:
            from hsflow.pyramid import warp

            f2w = warp(f2, bu, bv)
            d = solve_level(f1, f2w, cfg, cfg.iters)
            nu, nv = bu + d.u, bv + d.v
        else:
            fl = solve_level(f1, f2, cfg, cfg.iters, u0=bu, v0=bv)
            nu, nv = fl.u, fl.v
        return (nu, nv), (nu, nv)

    _, (us, vs) = lax.scan(body, (u0, v0), (pairs1, pairs2))
    return us, vs


def flow_stream_warm(
    frames: Union[np.ndarray, Iterable[np.ndarray]],
    cfg: HSConfig = HSConfig(),
    warm_scale: float = 1.0,
    chunk: int = 8,
    warp_prior: bool = False,
    fused: bool = True,
) -> Iterator[Flow]:
    """Sequential streaming flow with TEMPORAL warm start (round 4).

    Each pair's solve initializes u/v from the previous pair's flow
    (scaled by `warm_scale`; 1.0 assumes coherent motion frame to frame) —
    the standing flow field is itself the best available prior, so the
    iteration budget that `flow_stream` spends rediscovering it every
    pair can be cut several-fold at matched accuracy (measured in
    tests/integration/test_video_egomotion.py: on a smooth synthetic pan,
    warm iters=25 matches cold iters=100 EPE). Trades `flow_stream`'s
    chunked DP batching for per-pair latency and the iteration saving —
    the right mode for live camera feeds (solver.solve_level takes the
    warm start as its u0/v0). `chunk` only
    sizes the prefetch windows (P6 pipeline), not the batching.

    `warp_prior=True` additionally WARPS frame 2 by the prior before the
    solve and adds the residual back — the temporal analog of the
    pyramid's coarse-to-fine warp, for motion beyond the ~1 px HS
    linearization range: an init-only warm start cannot recover a 3
    px/frame pan at a small budget, the warp prior can
    (tests/integration/test_video_egomotion.py). The FIRST pair (no prior
    yet) bootstraps with a 3-level pyramid solve; after that every pair
    is one cheap full-resolution residual solve. Composes with cfg.tol.

    `fused=True` (default): after the bootstrap, each prefetch
    window's dependent solves run as ONE lax.scan jit region (`_warm_scan`)
    — one dispatch per chunk instead of per pair. Same arithmetic, same
    warm chain; `fused=False` keeps the per-pair dispatch for A/B.
    """
    from hsflow.solver import hs_solve

    prev: Optional[Flow] = None
    for cur in _prefetched_windows(frames, chunk):
        k0 = 0
        if prev is None:
            if warp_prior:
                from hsflow.config import PyramidConfig
                from hsflow.pyramid import hs_pyramid

                prev = hs_pyramid(cur[0], cur[1], cfg, PyramidConfig(levels=3))
            else:
                prev = hs_solve(cur[0], cur[1], cfg)
            yield prev
            k0 = 1
        if fused and cur.shape[0] - 1 > k0:
            us, vs = _warm_scan(cur[k0:-1], cur[k0 + 1:], prev.u, prev.v,
                                cfg, float(warm_scale), warp_prior)
            for k in range(us.shape[0]):
                prev = Flow(us[k], vs[k])
                yield prev
            continue
        for k in range(k0, cur.shape[0] - 1):
            if warp_prior:
                from hsflow.pyramid import warp

                base = Flow(prev.u * warm_scale, prev.v * warm_scale)
                f2w = warp(cur[k + 1], base.u, base.v)
                d = hs_solve(cur[k], f2w, cfg)
                prev = Flow(base.u + d.u, base.v + d.v)
            else:
                init = Flow(prev.u * warm_scale, prev.v * warm_scale)
                prev = hs_solve(cur[k], cur[k + 1], cfg, init=init)
            yield prev


def flow_stream_occlusion(
    frames: Union[np.ndarray, Iterable[np.ndarray]],
    cfg: HSConfig = HSConfig(),
    pyr: Optional[PyramidConfig] = None,
    chunk: int = 8,
    a: float = 0.01,
    b: float = 0.5,
    mesh=None,
    lk: Optional[LKConfig] = None,
    tvl1: Optional[TVL1Config] = None,
) -> Iterator[tuple[Flow, jnp.ndarray]]:
    """flow_stream plus per-pair occlusion masks: yields (forward Flow,
    boolean mask) per chunk.

    Both directions ride ONE 2B-batch solve per chunk (the backward pairs
    are appended to the same stack, so fwd+bwd share every kernel launch),
    then the forward-backward test (consistency.occlusion_mask) runs
    vmapped on device. Thresholds (a, b) as occlusion_mask. The test is
    model-agnostic: `lk=`/`tvl1=` switch the solver family exactly as in
    flow_stream (`cfg` is then ignored).
    """
    from functools import partial

    from hsflow.consistency import occlusion_mask

    if lk is not None and tvl1 is not None:
        raise ValueError("pass at most one of lk= and tvl1=")
    alt_pyr = None
    if lk is not None or tvl1 is not None:
        alt_pyr = pyr if pyr is not None else PyramidConfig(
            levels=1, iters_per_level=()
        )
    if lk is not None:
        from hsflow.lucas_kanade import lk_solve_batched
    if tvl1 is not None:
        from hsflow.tvl1 import tvl1_solve_batched

    mask_fn = jax.jit(jax.vmap(partial(occlusion_mask, a=a, b=b)))
    for cur in _prefetched_windows(frames, chunk):
        n = cur.shape[0] - 1
        m = mesh
        if m is not None and (2 * n) % m.shape["batch"]:
            m = None
        b1 = jnp.concatenate([cur[:-1], cur[1:]])
        b2 = jnp.concatenate([cur[1:], cur[:-1]])
        if lk is not None:
            f = lk_solve_batched(b1, b2, lk, alt_pyr, mesh=m)
        elif tvl1 is not None:
            f = tvl1_solve_batched(b1, b2, tvl1, alt_pyr, mesh=m)
        else:
            f = hs_solve_batched(b1, b2, cfg, pyr, mesh=m)
        fwd = Flow(f.u[:n], f.v[:n])
        bwd = Flow(f.u[n:], f.v[n:])
        yield fwd, mask_fn(fwd, bwd)


def flow_video(
    frames: np.ndarray,
    cfg: HSConfig = HSConfig(),
    pyr: Optional[PyramidConfig] = None,
    chunk: int = 8,
    mesh=None,
    lk: Optional[LKConfig] = None,
    tvl1: Optional[TVL1Config] = None,
) -> Flow:
    """Whole-video convenience: (T, H, W) frames -> (T-1, H, W) Flow.

    The result lives on the HOST (numpy): each chunk's flow is copied off
    the device as soon as the next chunk is in flight, so device memory
    stays bounded by one chunk regardless of video length. For on-device
    streaming consumption, use flow_stream directly.
    """
    us, vs = [], []
    for f in flow_stream(frames, cfg, pyr, chunk, mesh=mesh, lk=lk, tvl1=tvl1):
        us.append(np.asarray(f.u))
        vs.append(np.asarray(f.v))
    return Flow(np.concatenate(us, axis=0), np.concatenate(vs, axis=0))
