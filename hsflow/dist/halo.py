"""Ring halo exchange via lax.ppermute (SURVEY.md §2b P4, §2c).

The stencil analog of ring attention's block rotation: every Jacobi sweep
each device needs a ring of neighbor-device pixels. Exchange is two-phase —
x (columns) first, then y (rows) on the already-column-extended tile — so
corner pixels arrive without diagonal permutes (SURVEY.md §7 "ppermute
corner exchange"). At the global image boundary the halo is the tile's own
replicated edge, reproducing the clamp boundary condition of
ops.stencils exactly; a degenerate 1x1 mesh therefore matches the untiled
solver bit-for-bit (§2.5 distributed-correctness invariant).

All functions must be called inside shard_map with the mesh axes bound.
Supports an s-px halo for blockwise exchange (s sweeps per exchange,
SURVEY.md §2b P4 "blockwise variant").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

# Fault-injection hook (SURVEY.md §5.3): tests install a halo-corrupting
# callable to validate failure detection/recovery. Trace-time state, so
# installing/removing it clears the tiled solver's jit cache.
_FAULT_HOOK = None


def set_fault_hook(fn) -> None:
    """Install (or clear, with None) a halo corruption hook for fault tests."""
    global _FAULT_HOOK
    _FAULT_HOOK = fn
    from hsflow.dist import tiled_solver

    tiled_solver._tiled_impl.clear_cache()


def _shift_from_prev(x: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """Each rank receives x from rank-1 along axis_name (rank 0 gets zeros)."""
    n = lax.axis_size(axis_name)
    perm = [(i, i + 1) for i in range(n - 1)]
    return lax.ppermute(x, axis_name, perm)


def _shift_from_next(x: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """Each rank receives x from rank+1 along axis_name (last rank gets zeros)."""
    n = lax.axis_size(axis_name)
    perm = [(i + 1, i) for i in range(n - 1)]
    return lax.ppermute(x, axis_name, perm)


def _pad_axis(t: jnp.ndarray, s: int, axis_name: str, axis: int) -> jnp.ndarray:
    """Extend `axis` of the local tile by s entries of neighbor data each side."""
    idx = lax.axis_index(axis_name)
    n = lax.axis_size(axis_name)

    def take(sl):
        return t[(slice(None),) * axis + (sl,)]

    lo_halo = _shift_from_prev(take(slice(-s, None)), axis_name)  # prev's high edge
    hi_halo = _shift_from_next(take(slice(None, s)), axis_name)   # next's low edge
    # Global boundary: replicate own edge (clamp semantics, §2.5).
    edge_lo = jnp.repeat(take(slice(None, 1)), s, axis=axis)
    edge_hi = jnp.repeat(take(slice(-1, None)), s, axis=axis)
    lo_halo = jnp.where(idx == 0, edge_lo, lo_halo)
    hi_halo = jnp.where(idx == n - 1, edge_hi, hi_halo)
    return jnp.concatenate([lo_halo, t, hi_halo], axis=axis)


def halo_pad(
    t: jnp.ndarray,
    s: int = 1,
    y_axis: str = "y",
    x_axis: str = "x",
) -> jnp.ndarray:
    """(h, w) local tile -> (h+2s, w+2s) with neighbor halos + corners.

    Phase 1 exchanges columns along the x mesh axis; phase 2 exchanges rows of
    the column-extended tile along y, so the y-halos carry the corner pixels.
    """
    t = _pad_axis(t, s, x_axis, t.ndim - 1)
    t = _pad_axis(t, s, y_axis, t.ndim - 2)
    if _FAULT_HOOK is not None:
        t = _FAULT_HOOK(t)
    return t


def unpad(t: jnp.ndarray, s: int) -> jnp.ndarray:
    """Drop the s-px halo ring: inverse of halo_pad's extension."""
    return t[..., s:-s, s:-s]


def replicate_global_edges(
    t: jnp.ndarray,
    s: int,
    y_axis: str = "y",
    x_axis: str = "x",
) -> jnp.ndarray:
    """Re-assert clamp semantics on a padded tile's global-boundary halo.

    Needed between the sweeps of an s-sweep halo block (s > 1): the ghost
    ring at the true image boundary must track the *current* edge row/col
    every sweep, exactly as the clamped shifts of the untiled solver do.
    Interior-facing halos are left alone (they decay by design and the
    interior stays exact — §2.5 order-independence argument).
    """
    h2, w2 = t.shape[-2], t.shape[-1]
    rows = lax.broadcasted_iota(jnp.int32, (h2, w2), 0)
    cols = lax.broadcasted_iota(jnp.int32, (h2, w2), 1)
    is_top = lax.axis_index(y_axis) == 0
    is_bot = lax.axis_index(y_axis) == lax.axis_size(y_axis) - 1
    is_lft = lax.axis_index(x_axis) == 0
    is_rgt = lax.axis_index(x_axis) == lax.axis_size(x_axis) - 1
    t = jnp.where(is_top & (rows < s), t[..., s : s + 1, :], t)
    t = jnp.where(is_bot & (rows >= h2 - s), t[..., h2 - s - 1 : h2 - s, :], t)
    t = jnp.where(is_lft & (cols < s), t[..., :, s : s + 1], t)
    t = jnp.where(is_rgt & (cols >= w2 - s), t[..., :, w2 - s - 1 : w2 - s], t)
    return t
