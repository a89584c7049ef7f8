"""Reshard helpers between pipeline phases (SURVEY.md §2b P5 — Ulysses analog).

Phase transitions in a video pipeline want different layouts: decode/ingest
is naturally time-sharded (each device holds a contiguous frame run), the tiled
solve is space-sharded, separable filter passes prefer W-split then H-split.

The time<->space transitions are EXPLICIT shard_map collectives, not bare
`with_sharding_constraint`s: GSPMD cannot re-derive the device permutation
between P("batch", None, None) and P(None, "y", "x") on a 3-axis mesh and
falls back to "involuntary full rematerialization" — replicate the whole
tensor, then re-partition (exactly the all-frames copy P5 exists to
avoid). The hand-written lowering is
bandwidth-optimal: each device SLICES its local block down to what the
destination layout needs first, then all_gathers the pre-sliced tiles along
the axis being un-sharded — per-device traffic (1 - 1/n) of the final local
block, the same volume as an ideal all_to_all.

Also here: the P3 sequence-parallel pair construction — frames sharded along
time need one neighbor frame (temporal halo = 1 frame, SURVEY.md §2b P3) to
form their last local pair, exchanged with a ppermute.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def reshard(x: jnp.ndarray, mesh: Mesh, spec: P) -> jnp.ndarray:
    """Constrain x to NamedSharding(mesh, spec); inside jit this lowers to a
    collective layout change. Use for SAME-axes layout tweaks; for the
    batch<->space transition use time_to_space/space_to_time, whose explicit
    lowering avoids GSPMD's replicate-repartition fallback."""
    return jax.lax.with_sharding_constraint(x, NamedSharding(mesh, spec))


def _pad_to(x: jnp.ndarray, mults: tuple[int, int, int]) -> jnp.ndarray:
    pads = [(0, (-s) % m) for s, m in zip(x.shape, mults)]
    if any(p for _, p in pads):
        x = jnp.pad(x, pads)
    return x


def time_to_space(frames: jnp.ndarray, mesh: Mesh) -> jnp.ndarray:
    """(T, H, W) time-sharded P("batch", None, None) -> space-sharded
    P(None, "y", "x").

    Lowering (inside shard_map over the full mesh): each device holds
    (T/b, H, W); it slices out its OWN (y, x) spatial tile — (T/b, H/my,
    W/mx), a b·my·mx-fold reduction — then a tiled all_gather along "batch"
    assembles (T, H/my, W/mx). Communication: (1-1/b) of the final local
    block per device; no tensor is ever replicated in full.
    Non-divisible shapes are zero-padded to the mesh grid and cropped back.
    """
    b = mesh.shape["batch"]
    my, mx = mesh.shape["y"], mesh.shape["x"]
    t, h, w = frames.shape
    padded = _pad_to(frames, (b, my, mx))
    th, tw = padded.shape[1] // my, padded.shape[2] // mx

    def local(x):
        iy = lax.axis_index("y")
        ix = lax.axis_index("x")
        tile = lax.dynamic_slice(
            x, (0, iy * th, ix * tw), (x.shape[0], th, tw)
        )
        return lax.all_gather(tile, "batch", axis=0, tiled=True)

    out = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=P("batch", None, None),
        out_specs=P(None, "y", "x"),
        check_vma=False,
    )(padded)
    return out[:t, :h, :w]


def space_to_time(frames: jnp.ndarray, mesh: Mesh) -> jnp.ndarray:
    """(T, H, W) space-sharded P(None, "y", "x") -> time-sharded
    P("batch", None, None) — the inverse of time_to_space, same strategy:
    slice the local (T, H/my, W/mx) block down to this device's frame run
    (T/b frames), then tiled all_gathers along "y" then "x" reassemble the
    full spatial extent."""
    b = mesh.shape["batch"]
    my, mx = mesh.shape["y"], mesh.shape["x"]
    t, h, w = frames.shape
    padded = _pad_to(frames, (b, my, mx))
    k = padded.shape[0] // b

    def local(x):
        ib = lax.axis_index("batch")
        run = lax.dynamic_slice(
            x, (ib * k, 0, 0), (k, x.shape[1], x.shape[2])
        )
        run = lax.all_gather(run, "y", axis=1, tiled=True)
        return lax.all_gather(run, "x", axis=2, tiled=True)

    out = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=P(None, "y", "x"),
        out_specs=P("batch", None, None),
        check_vma=False,
    )(padded)
    return out[:t, :h, :w]


def timesharded_pairs(frames: jnp.ndarray):
    """Local (i1, i2) pair stacks for time-sharded frames, inside shard_map.

    Each shard holds k consecutive frames; its last pair needs the next
    shard's first frame — the 1-frame temporal halo (P3), fetched with a
    ppermute along "batch". The last shard's trailing pair is marked invalid
    (returned mask) since the video simply ends there.

    Returns (i1, i2, valid) each of leading length k: pair j is
    (frame j, frame j+1) in this shard's local numbering.
    """
    n = lax.axis_size("batch")
    idx = lax.axis_index("batch")
    # next shard's first frame -> my temporal halo
    halo = lax.ppermute(
        frames[:1], "batch", [(i + 1, i) for i in range(n - 1)]
    )
    ext = jnp.concatenate([frames, halo], axis=0)  # (k+1, H, W)
    i1 = ext[:-1]
    i2 = ext[1:]
    k = frames.shape[0]
    local = jnp.arange(k)
    # global pair index t = idx*k + local must have a successor frame
    valid = (idx * k + local) < (n * k - 1)
    return i1, i2, valid
