"""Tile geometry of the GPU Jacobi kernel: the wrapper's pass depth and tile
choice (pure Python), and the global-offset clamp masks the distributed
solver relies on (`tile_sweeps` in the Pallas interpreter vs the masked jnp
twin, ops.stencils.jacobi_step_masked)."""

import jax.numpy as jnp
import numpy as np
import pytest

from hsflow.kernels import jacobi as jk
from hsflow.ops import stencils


@pytest.mark.parametrize(
    "block_sweeps,n,expected",
    [(0, 100, jk.AUTO_BLOCK_SWEEPS), (0, 3, 3), (4, 100, 4), (4, 2, 2),
     (1, 50, 1), (40, 100, jk.MAX_BLOCK_SWEEPS), (16, 16, 16), (0, 1, 1)],
)
def test_pass_sweeps(block_sweeps, n, expected):
    assert jk.pass_sweeps(block_sweeps, n) == expected


@pytest.mark.parametrize(
    "halo,expected",
    [(1, (32, 128)), (4, (32, 128)), (5, (64, 128)), (6, (64, 128)),
     (8, (64, 128)), (16, (64, 128))],
)
def test_tile_shape(halo, expected):
    eh, ew = jk.tile_shape(halo)
    assert (eh, ew) == expected
    # Triton block shapes are powers of two; the owned tile is non-empty
    assert eh & (eh - 1) == 0 and ew & (ew - 1) == 0
    assert eh - 2 * halo >= 16 and ew - 2 * halo >= 64


@pytest.mark.parametrize(
    "h,w,halo",
    [(1080, 1920, 6), (2160, 3840, 6), (1, 1, 1), (37, 51, 4), (24, 120, 4),
     (25, 121, 4), (544, 960, 16), (1, 5000, 3), (5000, 1, 3), (67, 93, 8)],
)
def test_tile_grid_covers_frame_once(h, w, halo):
    eh, ew = jk.tile_shape(halo)
    oh, ow = eh - 2 * halo, ew - 2 * halo
    nty, ntx = jk.tile_grid(h, w, halo)
    assert nty * oh >= h > (nty - 1) * oh
    assert ntx * ow >= w > (ntx - 1) * ow


@pytest.mark.parametrize("halo", [1, 4, 5, 16])
def test_num_warps_keeps_32_pixels_per_thread(halo):
    eh, ew = jk.tile_shape(halo)
    assert jk._num_warps(eh, ew) * 32 * 32 == eh * ew


def _masked_oracle(u, v, ex, ey, et, invd, n, row0, col0, h, w):
    gr = row0 + jnp.arange(u.shape[0])[:, None]
    gc = col0 + jnp.arange(u.shape[1])[None, :]
    masks = stencils.edge_masks(gr, gc, h, w)
    for _ in range(n):
        u, v = stencils.jacobi_step_masked(u, v, ex, ey, et, invd, masks)
    return u, v


def _tile_fields(shape, seed):
    rng = np.random.default_rng(seed)
    u, v, ex, ey, et = (
        jnp.asarray(rng.uniform(-1, 1, shape).astype(np.float32))
        for _ in range(5)
    )
    return u, v, ex, ey, et, 1.0 / (0.25 + ex * ex + ey * ey)


@pytest.mark.parametrize(
    "tile,row0,col0,h,w,n",
    [
        ((23, 33), 7, 17, 50, 70, 3),      # interior tile
        ((20, 25), 0, 45, 50, 70, 3),      # top-right corner
        ((26, 30), 24, 0, 50, 70, 2),      # bottom-left corner
        ((20, 20), -2, -2, 16, 16, 2),     # halo beyond the top-left edge
        ((40, 140), 10, -4, 64, 130, 4),   # wider than one kernel tile
        ((9, 9), 3, 3, 9, 9, 1),           # tile larger than the image part
        ((70, 30), -5, 20, 60, 48, 5),     # taller than one kernel tile
        ((12, 200), 0, 0, 12, 200, 6),     # the whole image, offset 0
    ],
)
def test_tile_sweeps_global_masks(tile, row0, col0, h, w, n):
    """Clamp at TRUE image edges from the traced global offset; tile edges
    are garbage that decays inward, exactly like the masked jnp twin (the
    masked twin itself is exact everywhere, so compare where both are
    defined: the whole tile, since the kernel clamps at the array edge the
    same way concatenate-shifts do)."""
    f = _tile_fields(tile, seed=n)
    uo, vo = jk.tile_sweeps(*f, n, row0, col0, h, w, interpret=True)
    ur, vr = _masked_oracle(*f, n, row0, col0, h, w)
    # the ring within n px of the TILE edge (not the image edge) may differ
    sl = (slice(n, tile[0] - n), slice(n, tile[1] - n))
    assert float(jnp.abs(uo[sl] - ur[sl]).max(initial=0.0)) <= 1e-6
    assert float(jnp.abs(vo[sl] - vr[sl]).max(initial=0.0)) <= 1e-6


@pytest.mark.parametrize("r0,c0", [(0, 0), (5, 9), (16, 40)])
def test_tile_of_whole_image_matches_untiled(r0, c0):
    """A halo-padded crop of a frame, solved by tile_sweeps with its global
    offset, reproduces the untiled kernel solve on its owned region."""
    h, w, n = 40, 72, 4
    rng = np.random.default_rng(r0 + c0)
    full = [jnp.asarray(rng.uniform(-1, 1, (h, w)).astype(np.float32))
            for _ in range(5)]
    u, v, ex, ey, et = full
    invd = 1.0 / (0.25 + ex * ex + ey * ey)
    ref = jk.jacobi_sweeps(u, v, ex, ey, et, invd, n, block_sweeps=n,
                           interpret=True)
    th, tw = 16, 24
    top, left = max(r0 - n, 0), max(c0 - n, 0)
    sl = (slice(top, min(r0 + th + n, h)), slice(left, min(c0 + tw + n, w)))
    out = jk.tile_sweeps(u[sl], v[sl], ex[sl], ey[sl], et[sl], invd[sl], n,
                         top, left, h, w, interpret=True)
    own = (slice(r0 - top, r0 - top + th), slice(c0 - left, c0 - left + tw))
    np.testing.assert_allclose(np.asarray(out[0][own]),
                               np.asarray(ref[0][r0:r0 + th, c0:c0 + tw]),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(out[1][own]),
                               np.asarray(ref[1][r0:r0 + th, c0:c0 + tw]),
                               atol=1e-6)
