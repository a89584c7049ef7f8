"""Hopper Jacobi-sweep kernel: k sweeps per HBM pass (Pallas, Triton route).

The plain path (`ops.stencils.jacobi_step` in a loop) streams u, v, Ex,
Ey, Et and 1/den from device memory and writes u, v back on every sweep:
32 B/px/sweep, ~66 MB per 1080p sweep, more than the 50 MB L2. This kernel
runs `k` sweeps per pass instead. Each program owns an output tile and
loads it with a k-pixel halo (an "extended tile" of (eh, ew) pixels, powers
of two as Triton requires): the four loop-invariant fields stay in
registers for the whole pass, and u/v ping-pong through a per-program
scratch slot that L1 serves, with a block barrier between sweeps. Triton
has no in-register shift, so the eight neighbour reads of a sweep are
gathers from that slot. HBM then sees one read of the six fields and one
write of u/v per k sweeps, plus the scratch write-back. On an H200 this
runs 100 sweeps ~1.5x faster than XLA's plain loop at 1080p and 4K, and is
bound by the per-sweep barriers rather than by bytes (PERF.md).

Halo pixels read clamped garbage at the extended tile's own edge; that
error moves one ring inward per sweep, so after k <= halo sweeps the owned
tile is exact (the argument the tiled solver's halo exchange rests on).
The HS clamp fires at the TRUE image edge, given by global row/column
indices: `off` is the global position of array element (0, 0) and
(gh, gw) the true image size, so the same kernel serves whole frames
(off = 0) and the distributed solver's halo-padded shards.

Arithmetic follows `ops.stencils.jacobi_step` in the same association
order (separable [1,2,1] vertical sum, then horizontal), so kernel and jnp
agree to FMA contraction.

Interpret mode (the CPU tests) is an explicit argument, or the
`interpret_mode()` context that tests enter; no code here picks it from the
platform. Off the GPU, and outside that context, the kernel is an error.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from hsflow.ops import stencils

TILE_W = 128           # extended-tile width (lanes of a row of loads)
AUTO_BLOCK_SWEEPS = 6  # sweeps per pass when HSConfig.block_sweeps == 0
MAX_BLOCK_SWEEPS = 16  # keeps >= 32 x 96 owned pixels per 64 x 128 tile

_INTERPRET = contextvars.ContextVar("hsflow_pallas_interpret", default=False)


@contextlib.contextmanager
def interpret_mode():
    """Run the kernel in the Pallas interpreter inside this context (tests)."""
    token = _INTERPRET.set(True)
    try:
        yield
    finally:
        _INTERPRET.reset(token)


def interpreting() -> bool:
    return _INTERPRET.get()


def pass_sweeps(block_sweeps: int, n_sweeps: int) -> int:
    """Sweeps per HBM pass: cfg.block_sweeps (0 = auto), capped by the tile
    geometry and by the solve length."""
    k = block_sweeps if block_sweeps > 0 else AUTO_BLOCK_SWEEPS
    return max(1, min(k, MAX_BLOCK_SWEEPS, n_sweeps))


def tile_shape(halo: int) -> tuple[int, int]:
    """Extended tile (eh, ew) for a `halo`-pixel halo: 32 rows up to a
    4-pixel halo, 64 beyond (a 32-row tile would own too few rows)."""
    eh = 32 if halo <= 4 else 64
    return eh, TILE_W


def tile_grid(h: int, w: int, halo: int) -> tuple[int, int]:
    """Number of (row, column) tiles covering an h x w frame."""
    eh, ew = tile_shape(halo)
    return pl.cdiv(h, eh - 2 * halo), pl.cdiv(w, ew - 2 * halo)


def _num_warps(eh: int, ew: int) -> int:
    """4 warps per 32 x 128 tile, 8 per 64 x 128: 32 pixels a thread."""
    return eh * ew // 1024


def _sweep_kernel(off_ref, ex_ref, ey_ref, et_ref, invd_ref, u_ref, v_ref,
                  uo_ref, vo_ref, s_ref, *, k: int, halo: int, eh: int,
                  ew: int, h: int, w: int, gh: int, gw: int, interpret: bool):
    b = pl.program_id(0)
    ty = pl.program_id(1)
    tx = pl.program_id(2)
    oh, ow = eh - 2 * halo, ew - 2 * halo
    li = lax.broadcasted_iota(jnp.int32, (eh, 1), 0)
    lj = lax.broadcasted_iota(jnp.int32, (1, ew), 1)
    r = ty * oh - halo + li             # array row of each tile row
    c = tx * ow - halo + lj
    rc = jnp.clip(r, 0, h - 1)          # in-bounds gather indices
    cc = jnp.clip(c, 0, w - 1)
    gr = off_ref[0] + r                 # global row/col for the HS clamp
    gc = off_ref[1] + c
    up = jnp.where(gr == 0, li, jnp.maximum(li - 1, 0))
    dn = jnp.where(gr == gh - 1, li, jnp.minimum(li + 1, eh - 1))
    lf = jnp.where(gc == 0, lj, jnp.maximum(lj - 1, 0))
    rt = jnp.where(gc == gw - 1, lj, jnp.minimum(lj + 1, ew - 1))

    def load(ref):
        return ref[b, rc, cc]

    ex, ey, et, invd = (load(x) for x in (ex_ref, ey_ref, et_ref, invd_ref))
    u, v = load(u_ref), load(v_ref)

    ntiles = pl.num_programs(1) * pl.num_programs(2)
    slot = ((b * ntiles + ty * pl.num_programs(2) + tx) * 4) * eh

    def put(buf, fld, x):
        s_ref[slot + (2 * buf + fld) * eh + li, lj] = x

    def sync():
        if not interpret:  # the interpreter runs a program's ops in order
            plgpu.debug_barrier()

    def navg(buf, fld, a):
        base = slot + (2 * buf + fld) * eh

        def vsum(cols, mid):
            return (s_ref[base + up, cols] + 2.0 * mid
                    + s_ref[base + dn, cols])

        t_c = vsum(lj, a)
        t_l = vsum(lf, s_ref[base + li, lf])
        t_r = vsum(rt, s_ref[base + li, rt])
        s = t_l + 2.0 * t_c + t_r
        return s * (1.0 / 12.0) - a * (1.0 / 3.0)

    def sweep(i, uv):
        cur = lax.rem(i, 2)
        ubar = navg(cur, 0, uv[0])
        vbar = navg(cur, 1, uv[1])
        frac = (ex * ubar + ey * vbar + et) * invd
        un = ubar - ex * frac
        vn = vbar - ey * frac
        put(1 - cur, 0, un)
        put(1 - cur, 1, vn)
        sync()
        return un, vn

    put(0, 0, u)
    put(0, 1, v)
    sync()
    # a loop, not k unrolled copies: Triton's compile time stays flat in k
    u, v = lax.fori_loop(0, k, sweep, (u, v))

    owned = ((li >= halo) & (li < halo + oh) & (r < h)
             & (lj >= halo) & (lj < halo + ow) & (c < w))
    # unclamped indices: every lane addresses a distinct element, and the
    # masked-off ones (halo, beyond the frame) store nothing
    plgpu.store(uo_ref.at[b, r, c], u, mask=owned)
    plgpu.store(vo_ref.at[b, r, c], v, mask=owned)


def _one_pass(u, v, ex, ey, et, invd, off, k, halo, gh, gw, interpret):
    """k sweeps (k <= halo) on (B, h, w) fields in one pallas_call."""
    bsz, h, w = u.shape
    eh, ew = tile_shape(halo)
    nty, ntx = tile_grid(h, w, halo)
    field = jax.ShapeDtypeStruct(u.shape, u.dtype)
    scratch = jax.ShapeDtypeStruct((bsz * nty * ntx * 4 * eh, ew), u.dtype)
    anyspec = pl.BlockSpec(memory_space=pl.ANY)
    uo, vo, _ = pl.pallas_call(
        functools.partial(_sweep_kernel, k=k, halo=halo, eh=eh, ew=ew, h=h,
                          w=w, gh=gh, gw=gw, interpret=interpret),
        grid=(bsz, nty, ntx),
        out_shape=(field, field, scratch),
        in_specs=[anyspec] * 7,
        out_specs=(anyspec,) * 3,
        compiler_params=plgpu.CompilerParams(
            num_warps=_num_warps(eh, ew), num_stages=1
        ),
        interpret=interpret,
        name="hs_jacobi_sweeps",
    )(off, ex, ey, et, invd, u, v)
    return uo, vo


def _sweeps_impl(u, v, ex, ey, et, invd, off, n_sweeps, block_sweeps, gh, gw,
                 interpret):
    k = pass_sweeps(block_sweeps, n_sweeps)
    n_pass, rem = divmod(n_sweeps, k)

    def full(_, uv):
        return _one_pass(*uv, ex, ey, et, invd, off, k, k, gh, gw, interpret)

    uv = (u, v)
    if n_pass == 1:
        uv = full(0, uv)
    elif n_pass > 1:
        uv = lax.fori_loop(0, n_pass, full, uv)
    if rem:
        uv = _one_pass(*uv, ex, ey, et, invd, off, rem, k, gh, gw, interpret)
    return uv


def _check_platform(interpret: bool) -> None:
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "the Pallas Jacobi kernel compiles for the GPU only; on "
            f"{jax.default_backend()!r} use backend='jnp' (or interpret "
            "mode in tests)"
        )


def _jnp_sweeps(u, v, ex, ey, et, invd, n_sweeps):
    """The jnp twin of the kernel, reverse-differentiable; the backward pass
    below rides its VJP. sqrt(n)-checkpointed, same forward arithmetic."""
    return stencils.checkpointed_loop(
        lambda uv: stencils.jacobi_step(uv[0], uv[1], ex, ey, et, invd),
        (u, v), n_sweeps,
    )


@functools.partial(jax.custom_vjp, nondiff_argnums=(6, 7, 8))
def _sweeps_ad(u, v, ex, ey, et, inv_den, n_sweeps, block_sweeps, interpret):
    bsz, h, w = u.shape
    off = jnp.zeros((2,), jnp.int32)
    return _sweeps_impl(u, v, ex, ey, et, inv_den, off, n_sweeps,
                        block_sweeps, h, w, interpret)


def _sweeps_ad_fwd(u, v, ex, ey, et, inv_den, n_sweeps, block_sweeps,
                   interpret):
    out = _sweeps_ad(u, v, ex, ey, et, inv_den, n_sweeps, block_sweeps,
                     interpret)
    return out, (u, v, ex, ey, et, inv_den)


def _sweeps_ad_bwd(n_sweeps, block_sweeps, interpret, res, ct):
    _, vjp = jax.vjp(lambda *a: _jnp_sweeps(*a, n_sweeps), *res)
    return vjp(ct)


_sweeps_ad.defvjp(_sweeps_ad_fwd, _sweeps_ad_bwd)


def jacobi_sweeps(
    u: jnp.ndarray,
    v: jnp.ndarray,
    ex: jnp.ndarray,
    ey: jnp.ndarray,
    et: jnp.ndarray,
    inv_den: jnp.ndarray,
    n_sweeps: int,
    block_sweeps: int = 0,
    interpret: bool | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """n Jacobi sweeps on (H, W) fields or a (B, H, W) stack (batch = grid
    axis), block_sweeps per HBM pass (0 = auto).

    Differentiable: a custom_vjp runs the kernel forward and the VJP of the
    jnp twin backward, so gradients equal the jnp backend's.
    """
    if u.ndim not in (2, 3):
        raise ValueError(f"jacobi_sweeps expects (H, W) or (B, H, W), "
                         f"got {u.shape}")
    if interpret is None:
        interpret = interpreting()
    _check_platform(interpret)
    if n_sweeps == 0 or u.size == 0:
        return u, v
    if u.ndim == 2:
        out = _sweeps_ad(*(a[None] for a in (u, v, ex, ey, et, inv_den)),
                         n_sweeps, block_sweeps, interpret)
        return out[0][0], out[1][0]
    return _sweeps_ad(u, v, ex, ey, et, inv_den, n_sweeps, block_sweeps,
                      interpret)


def tile_sweeps(
    u: jnp.ndarray,
    v: jnp.ndarray,
    ex: jnp.ndarray,
    ey: jnp.ndarray,
    et: jnp.ndarray,
    inv_den: jnp.ndarray,
    n_sweeps: int,
    row0,
    col0,
    h: int,
    w: int,
    interpret: bool | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """n sweeps on one shard's halo-padded tile (distributed solver).

    (row0, col0) are the traced global coordinates of the tile's element
    (0, 0), halo included and possibly negative; (h, w) is the true image
    size. The clamp fires only at true image edges; the tile's own edges
    decay one ring per sweep, which the caller's halo (>= n_sweeps) absorbs.
    """
    if interpret is None:
        interpret = interpreting()
    _check_platform(interpret)
    if n_sweeps == 0:
        return u, v
    off = jnp.stack([jnp.asarray(row0, jnp.int32),
                     jnp.asarray(col0, jnp.int32)])
    uo, vo = _sweeps_impl(
        *(a[None] for a in (u, v, ex, ey, et, inv_den)), off, n_sweeps,
        n_sweeps, h, w, interpret,
    )
    return uo[0], vo[0]
