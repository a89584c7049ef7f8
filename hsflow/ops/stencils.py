"""Pure-jnp Horn-Schunck stencil ops (component N2, SURVEY.md §2d — layer T1).

Reference semantics (SURVEY.md §2.5), expressed as shift-add compositions that
XLA fuses into a handful of elementwise kernels. These are the CPU-runnable
equivalents of the reference's OpenCL kernels R1-R3 (SURVEY.md §2a) and the
correctness twin of the GPU kernel in hsflow/kernels/.

All shifts use replicate (clamp) boundary handling, implemented as
slice+concatenate rather than `jnp.pad` so XLA keeps everything in one fusion.
"""

from __future__ import annotations

import jax.numpy as jnp

# -- replicate-clamped shifts over the last two axes (supports leading batch) --


def shift_up_row(a: jnp.ndarray) -> jnp.ndarray:
    """a(i+1, j), clamped at the last row."""
    return jnp.concatenate([a[..., 1:, :], a[..., -1:, :]], axis=-2)


def shift_down_row(a: jnp.ndarray) -> jnp.ndarray:
    """a(i-1, j), clamped at the first row."""
    return jnp.concatenate([a[..., :1, :], a[..., :-1, :]], axis=-2)


def shift_left_col(a: jnp.ndarray) -> jnp.ndarray:
    """a(i, j+1), clamped at the last column."""
    return jnp.concatenate([a[..., :, 1:], a[..., :, -1:]], axis=-1)


def shift_right_col(a: jnp.ndarray) -> jnp.ndarray:
    """a(i, j-1), clamped at the first column."""
    return jnp.concatenate([a[..., :, :1], a[..., :, :-1]], axis=-1)


def derivatives(
    i1: jnp.ndarray, i2: jnp.ndarray, variant: str = "hs_cube"
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Spatiotemporal derivatives Ex, Ey, Et (SURVEY.md §2.5 eq. D).

    hs_cube: forward differences averaged over the 2x2x2 spatiotemporal cube
    (HS81 §7); central: central differences + Et = I2 - I1.
    """
    if variant == "hs_cube":
        ex = jnp.zeros_like(i1)
        ey = jnp.zeros_like(i1)
        for f in (i1, i2):
            fr = shift_up_row(f)
            fc = shift_left_col(f)
            frc = shift_left_col(fr)
            ex = ex + (fc - f) + (frc - fr)
            ey = ey + (fr - f) + (frc - fc)
        ex = ex * 0.25
        ey = ey * 0.25
        d = i2 - i1
        et = 0.25 * (d + shift_up_row(d) + shift_left_col(d) + shift_left_col(shift_up_row(d)))
        return ex, ey, et
    elif variant == "central":
        ex = 0.5 * (shift_left_col(i1) - shift_right_col(i1))
        ey = 0.5 * (shift_up_row(i1) - shift_down_row(i1))
        et = i2 - i1
        return ex, ey, et
    raise ValueError(f"unknown derivative variant {variant!r}")


def neighbor_avg(u: jnp.ndarray) -> jnp.ndarray:
    """8-neighbor 1/6-1/12 weighted average, replicate edges (SURVEY.md §2.5 eq. A).

    Computed in separable form: the HS weight matrix equals
    [1,2,1]x[1,2,1]/12 with the center zeroed, i.e.
    conv_sep(u, [1,2,1], [1,2,1])/12 - u/3, which is identical under
    replicate padding and halves the shifts. The association order here
    is mirrored exactly by the GPU kernel (kernels/jacobi.py), so kernel
    and jnp agree to FMA contraction.
    """
    t = shift_down_row(u) + 2.0 * u + shift_up_row(u)
    s = shift_right_col(t) + 2.0 * t + shift_left_col(t)
    return s * (1.0 / 12.0) - u * (1.0 / 3.0)


# -- true-edge-masked variants -------------------------------------------------
#
# Twins of the ops above for tiles of a larger global image: the HS clamp
# must fire at the TRUE image edge (a boolean mask from global coordinates),
# not at the tile's array edge. Same arithmetic association order as both the
# unmasked ops and the GPU kernel (kernels/jacobi.py), so
# tiled == untiled holds to float equality for any tile/pad geometry; array
# rows/cols outside the true image (zero-pad or decaying halo) are garbage
# that true pixels never read.


def edge_masks(gr: jnp.ndarray, gc: jnp.ndarray, h: int, w: int):
    """(top, bottom, left, right) boolean grids from global row/col grids."""
    return (gr == 0, gr == h - 1, gc == 0, gc == w - 1)


def neighbor_avg_masked(u: jnp.ndarray, masks) -> jnp.ndarray:
    """neighbor_avg with the clamp at the true image edges given by masks."""
    m_top, m_bot, m_lf, m_rt = masks
    up = jnp.where(m_top, u, shift_down_row(u))   # u(i-1)
    dn = jnp.where(m_bot, u, shift_up_row(u))     # u(i+1)
    t = up + 2.0 * u + dn
    rt = jnp.where(m_lf, t, shift_right_col(t))   # t(j-1)
    lf = jnp.where(m_rt, t, shift_left_col(t))    # t(j+1)
    s = rt + 2.0 * t + lf
    return s * (1.0 / 12.0) - u * (1.0 / 3.0)


def jacobi_step_masked(
    u: jnp.ndarray,
    v: jnp.ndarray,
    ex: jnp.ndarray,
    ey: jnp.ndarray,
    et: jnp.ndarray,
    inv_den: jnp.ndarray,
    masks,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """jacobi_step with true-edge masks (tile bodies of the tiled solver)."""
    ubar = neighbor_avg_masked(u, masks)
    vbar = neighbor_avg_masked(v, masks)
    frac = (ex * ubar + ey * vbar + et) * inv_den
    return ubar - ex * frac, vbar - ey * frac


def sor_step_masked(
    u: jnp.ndarray,
    v: jnp.ndarray,
    ex: jnp.ndarray,
    ey: jnp.ndarray,
    et: jnp.ndarray,
    inv_den: jnp.ndarray,
    omega: float,
    colors,
    masks,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """sor_step with true-edge masks for tile bodies of the tiled solver.

    `colors` MUST be built from GLOBAL pixel coordinates (a tile's local
    parity differs from the image's whenever its offset is odd); the tiled
    solver passes (gr % 2, gc % 2) grids. Unlike Jacobi, a color stage reads
    pixels updated THIS sweep, so halo contamination grows one ring per
    STAGE: s sweeps per exchange block need a 4*s-px halo (4 colors/sweep).
    """
    for cm in colors:
        ubar = neighbor_avg_masked(u, masks)
        vbar = neighbor_avg_masked(v, masks)
        frac = (ex * ubar + ey * vbar + et) * inv_den
        un = ubar - ex * frac
        vn = vbar - ey * frac
        u = jnp.where(cm, u + omega * (un - u), u)
        v = jnp.where(cm, v + omega * (vn - v), v)
    return u, v


def derivatives_masked(
    i1: jnp.ndarray, i2: jnp.ndarray, masks, variant: str = "hs_cube"
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """derivatives with the clamp at the true image edges given by masks."""
    m_top, m_bot, m_lf, m_rt = masks

    def up_row(a):  # a(i+1), clamped at the true bottom edge
        return jnp.where(m_bot, a, shift_up_row(a))

    def left_col(a):  # a(j+1), clamped at the true right edge
        return jnp.where(m_rt, a, shift_left_col(a))

    if variant == "hs_cube":
        ex = jnp.zeros_like(i1)
        ey = jnp.zeros_like(i1)
        for f in (i1, i2):
            fr = up_row(f)
            fc = left_col(f)
            frc = left_col(fr)
            ex = ex + (fc - f) + (frc - fr)
            ey = ey + (fr - f) + (frc - fc)
        ex = ex * 0.25
        ey = ey * 0.25
        d = i2 - i1
        et = 0.25 * (d + up_row(d) + left_col(d) + left_col(up_row(d)))
        return ex, ey, et
    elif variant == "central":

        def down_row(a):  # a(i-1), clamped at the true top edge
            return jnp.where(m_top, a, shift_down_row(a))

        def right_col(a):  # a(j-1), clamped at the true left edge
            return jnp.where(m_lf, a, shift_right_col(a))

        ex = 0.5 * (left_col(i1) - right_col(i1))
        ey = 0.5 * (up_row(i1) - down_row(i1))
        et = i2 - i1
        return ex, ey, et
    raise ValueError(f"unknown derivative variant {variant!r}")


def color_masks(h: int, w: int) -> tuple:
    """The four 2x2-parity color grids for multi-color relaxation.

    The HS neighborhood couples all 8 neighbors (diagonals included), so a
    2-coloring cannot decouple it; under the (row%2, col%2) 4-coloring no
    two same-color pixels are neighbors, making the parallel per-color
    update EXACTLY a Gauss-Seidel ordering (colors sequentially, pixels
    within a color simultaneously)."""
    gr = jnp.arange(h)[:, None]
    gc = jnp.arange(w)[None, :]
    return tuple(
        (gr % 2 == pi) & (gc % 2 == pj) for pi in (0, 1) for pj in (0, 1)
    )


def sor_step(
    u: jnp.ndarray,
    v: jnp.ndarray,
    ex: jnp.ndarray,
    ey: jnp.ndarray,
    et: jnp.ndarray,
    inv_den: jnp.ndarray,
    omega: float,
    colors,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One 4-color SOR sweep (successive over-relaxation, cfg.solver="sor").

    Per color c: compute the Jacobi target (u*, v*) from the CURRENT field
    (which already contains this sweep's earlier colors — Gauss-Seidel
    ordering) and blend u <- u + omega*(u* - u) on c's pixels only. With
    omega = 1 this is exact 4-color Gauss-Seidel; 1 < omega < 2 is SOR,
    the classic variational-flow accelerator (Bruhn et al. 2005). Costs
    4 neighborhood averages per sweep but cuts the iteration count by an
    order of magnitude or more at small alpha (tests/unit/test_sor.py).

    Association order matches neighbor_avg/jacobi_step exactly.
    """
    for cm in colors:
        ubar = neighbor_avg(u)
        vbar = neighbor_avg(v)
        frac = (ex * ubar + ey * vbar + et) * inv_den
        un = ubar - ex * frac
        vn = vbar - ey * frac
        u = jnp.where(cm, u + omega * (un - u), u)
        v = jnp.where(cm, v + omega * (vn - v), v)
    return u, v


def jacobi_step(
    u: jnp.ndarray,
    v: jnp.ndarray,
    ex: jnp.ndarray,
    ey: jnp.ndarray,
    et: jnp.ndarray,
    inv_den: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One fused Jacobi sweep: average + update (SURVEY.md §2.5 eq. U).

    `inv_den = 1 / (alpha^2 + Ex^2 + Ey^2)` is loop-invariant and precomputed
    once by the solver (SURVEY.md §3.2) so the sweep reads 6 arrays and writes
    2 — the quantity the HBM roofline in SURVEY.md §6 is computed from.
    """
    ubar = neighbor_avg(u)
    vbar = neighbor_avg(v)
    frac = (ex * ubar + ey * vbar + et) * inv_den
    return ubar - ex * frac, vbar - ey * frac


def checkpointed_loop(step, uv, n: int):
    """Run `n` identical relaxation steps with sqrt(n) rematerialization.

    Forward arithmetic is EXACTLY `n` applications of `step` (the oracle
    invariant is untouched); the loop is structured as a lax.scan over
    ~sqrt(n) jax.checkpoint-wrapped blocks so reverse-mode AD stores only
    the block-boundary states and recomputes within blocks — gradient
    memory drops from O(n) field-sized residuals (tens of GB at 1080p x
    hundreds of sweeps, an instant OOM) to O(sqrt(n)). Loop-invariant data
    closed over by `step` is saved once, not per block.

    On an H200 (700 W) the nesting is free: 100 sweeps at 1080x1920 take
    4.80 ms nested vs 4.78 ms as one flat fori_loop, 16.19 vs 16.15 ms at
    2160x3840 (PERF.md). Two alternatives were rejected earlier: (a) flat
    forward + custom_vjp sqrt-replay backward breaks forward-mode AD
    (jvp), an advertised capability (tests/integration/test_autodiff.py);
    (b) Python-unrolling the block body lets XLA reassociate the
    straight-line chain — forward is no longer bitwise equal to the plain
    loop (~9e-8, breaking the oracle-identity tests) — and multiplies
    compile time. prevent_cse=False: sound inside the scan, never worse.
    """
    import functools
    import math

    import jax
    from jax import lax

    if n <= 0:
        return uv
    b = int(math.isqrt(n))
    if b < 2:
        return lax.fori_loop(0, n, lambda _, x: step(x), uv)
    n_blocks, rem = divmod(n, b)

    @functools.partial(jax.checkpoint, prevent_cse=False)
    def block(x):
        return lax.fori_loop(0, b, lambda _, y: step(y), x)

    uv, _ = lax.scan(lambda c, _: (block(c), None), uv, None, length=n_blocks)
    if rem:
        uv = lax.fori_loop(0, rem, lambda _, x: step(x), uv)
    return uv
