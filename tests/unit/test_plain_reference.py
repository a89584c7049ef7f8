"""The plain jnp path — the reference every kernel and tiled schedule is held
to — against the float64 NumPy golden solver, on edge shapes; its
true-edge-masked twins against the unmasked ops; a jnp twin of the tiled
(halo-decay) sweep schedule; and solve-to-tolerance budget rounding."""

import jax.numpy as jnp
import numpy as np
import pytest

from hsflow.config import HSConfig
from hsflow.ops import golden, stencils
from hsflow.solver import hs_solve


def _imgs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, shape).astype(np.float32),
            rng.uniform(0, 1, shape).astype(np.float32))


def _whole_masks(h, w):
    gr = jnp.arange(h)[:, None]
    gc = jnp.arange(w)[None, :]
    return stencils.edge_masks(gr, gc, h, w)


@pytest.mark.parametrize("shape", [(1, 1), (1, 7), (7, 1), (2, 3), (5, 9),
                                   (16, 16)])
@pytest.mark.parametrize("variant", ["hs_cube", "central"])
def test_jnp_solve_matches_golden_on_edge_shapes(shape, variant):
    i1, i2 = _imgs(shape, seed=sum(shape))
    f = hs_solve(jnp.asarray(i1), jnp.asarray(i2),
                 HSConfig(alpha=0.7, iters=12, deriv_variant=variant,
                          backend="jnp"))
    gu, gv = golden.hs_numpy(i1, i2, 0.7, 12, variant)
    assert float(np.abs(np.asarray(f.u) - gu).max()) <= 2e-6
    assert float(np.abs(np.asarray(f.v) - gv).max()) <= 2e-6


@pytest.mark.parametrize("shape", [(1, 5), (9, 1), (12, 17)])
@pytest.mark.parametrize("variant", ["hs_cube", "central"])
def test_masked_derivatives_match_unmasked(shape, variant):
    i1, i2 = (jnp.asarray(a) for a in _imgs(shape, seed=3))
    ref = stencils.derivatives(i1, i2, variant)
    got = stencils.derivatives_masked(i1, i2, _whole_masks(*shape), variant)
    for a, b in zip(ref, got):
        assert float(jnp.abs(a - b).max()) == 0.0


@pytest.mark.parametrize("shape", [(1, 1), (1, 6), (6, 1), (11, 13)])
def test_masked_jacobi_step_matches_unmasked(shape):
    rng = np.random.default_rng(4)
    u, v, ex, ey, et = (jnp.asarray(rng.uniform(-1, 1, shape).astype(np.float32))
                        for _ in range(5))
    invd = 1.0 / (0.25 + ex * ex + ey * ey)
    ref = stencils.jacobi_step(u, v, ex, ey, et, invd)
    got = stencils.jacobi_step_masked(u, v, ex, ey, et, invd,
                                      _whole_masks(*shape))
    for a, b in zip(ref, got):
        assert float(jnp.abs(a - b).max()) == 0.0


@pytest.mark.parametrize("tile", [(8, 8), (7, 12), (16, 5)])
@pytest.mark.parametrize("n", [1, 3])
def test_halo_tiled_schedule_matches_whole_frame(tile, n):
    """The schedule the kernel and the tiled solver share, in plain jnp:
    cut the frame into tiles, give each an n-pixel halo, run n masked
    sweeps on the haloed tile with global-offset masks, keep the owned
    part. Stitched, it equals n sweeps on the whole frame."""
    h, w = 23, 29
    rng = np.random.default_rng(n)
    u, v, ex, ey, et = (jnp.asarray(rng.uniform(-1, 1, (h, w)).astype(np.float32))
                        for _ in range(5))
    invd = 1.0 / (0.25 + ex * ex + ey * ey)
    ru, rv = u, v
    for _ in range(n):
        ru, rv = stencils.jacobi_step(ru, rv, ex, ey, et, invd)
    th, tw = tile
    out_u = np.zeros((h, w), np.float32)
    out_v = np.zeros((h, w), np.float32)
    for r0 in range(0, h, th):
        for c0 in range(0, w, tw):
            top, left = max(r0 - n, 0), max(c0 - n, 0)
            bot, right = min(r0 + th + n, h), min(c0 + tw + n, w)
            sl = (slice(top, bot), slice(left, right))
            gr = top + jnp.arange(bot - top)[:, None]
            gc = left + jnp.arange(right - left)[None, :]
            masks = stencils.edge_masks(gr, gc, h, w)
            tu, tv = u[sl], v[sl]
            for _ in range(n):
                tu, tv = stencils.jacobi_step_masked(
                    tu, tv, ex[sl], ey[sl], et[sl], invd[sl], masks)
            oh, ow = min(th, h - r0), min(tw, w - c0)
            own = (slice(r0 - top, r0 - top + oh),
                   slice(c0 - left, c0 - left + ow))
            out_u[r0:r0 + oh, c0:c0 + ow] = np.asarray(tu[own])
            out_v[r0:r0 + oh, c0:c0 + ow] = np.asarray(tv[own])
    assert float(np.abs(out_u - np.asarray(ru)).max()) == 0.0
    assert float(np.abs(out_v - np.asarray(rv)).max()) == 0.0


@pytest.mark.parametrize("iters,block", [(10, 3), (16, 4), (7, 7), (5, 8)])
def test_unreachable_tol_runs_whole_blocks(iters, block):
    """sweeps_until's budget rounds DOWN to whole check blocks (a block
    larger than the budget shrinks to it)."""
    i1, i2 = (jnp.asarray(a) for a in _imgs((12, 20), seed=9))
    ft = hs_solve(i1, i2, HSConfig(alpha=0.5, iters=iters, tol=1e-30,
                                   block_sweeps=block, backend="jnp"))
    b = min(block, iters)
    ff = hs_solve(i1, i2, HSConfig(alpha=0.5, iters=(iters // b) * b,
                                   backend="jnp"))
    assert float(jnp.abs(ft.u - ff.u).max()) == 0.0
    assert float(jnp.abs(ft.v - ff.v).max()) == 0.0
