"""Horn-Schunck solver core (component N3, SURVEY.md §2d — layer T2).

The device-resident replacement for the reference's host-driven hot loop
(SURVEY.md §3.1): instead of n x (enqueue average kernel, enqueue update
kernel, swap ping-pong buffers) with per-launch overhead, the whole solve is
one `jax.jit` region — derivatives once, loop-invariant `inv_den` hoisted,
then a loop of fused Jacobi sweeps that never leaves the device
(SURVEY.md §3.2).

Backends (HSConfig.backend):
  - "jnp":    plain jnp sweeps (ops/stencils.py) that XLA compiles for any
              platform; the reference for every other path.
  - "pallas": the GPU Jacobi kernel (kernels/jacobi.py): k sweeps per HBM
              pass. An error on any other platform, except inside the
              kernel module's test-only interpret context.
  - "auto":   the path that won the on-card A/B on the GPU (PERF.md),
              "jnp" elsewhere.
SOR, multigrid and robust relaxation are jnp on every backend.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from hsflow.config import HSConfig
from hsflow.ops import stencils

# What "auto" resolves to on the GPU: the winner of the kernel-vs-XLA A/B
# on the card (PERF.md, Findings).
GPU_AUTO_BACKEND = "pallas"


class Flow(NamedTuple):
    """Dense flow field. u = horizontal (x / column) motion, v = vertical."""

    u: jnp.ndarray
    v: jnp.ndarray


def resolve_backend(backend: str) -> str:
    """Map HSConfig.backend to the path that runs: "jnp" or "pallas"."""
    from hsflow.kernels.jacobi import interpreting

    on_gpu = jax.default_backend() == "gpu"
    if backend == "auto":
        return GPU_AUTO_BACKEND if on_gpu else "jnp"
    if backend == "pallas" and not (on_gpu or interpreting()):
        raise ValueError(
            "backend='pallas' is the GPU kernel; this process runs on "
            f"{jax.default_backend()!r} — use backend='jnp' or 'auto'"
        )
    return backend


def precompute(i1: jnp.ndarray, i2: jnp.ndarray, cfg: HSConfig):
    """Derivatives + hoisted 1/(alpha^2 + Ex^2 + Ey^2) (SURVEY.md §3.2).
    One elementwise-plus-shift fusion for XLA on every backend."""
    dtype = jnp.dtype(cfg.dtype)
    i1 = i1.astype(dtype)
    i2 = i2.astype(dtype)
    ex, ey, et = stencils.derivatives(i1, i2, cfg.deriv_variant)
    inv_den = 1.0 / (cfg.alpha * cfg.alpha + ex * ex + ey * ey)
    return ex, ey, et, inv_den


def sweeps(
    u: jnp.ndarray,
    v: jnp.ndarray,
    ex: jnp.ndarray,
    ey: jnp.ndarray,
    et: jnp.ndarray,
    inv_den: jnp.ndarray,
    n: int,
    cfg: HSConfig,
) -> Flow:
    """Run `n` relaxation sweeps on-device. `n` and `cfg` are trace-static."""
    backend = resolve_backend(cfg.backend)
    if n == 0:
        return Flow(u, v)
    if cfg.solver == "multigrid":
        # V-cycles (n = cycle count), jnp on every backend.
        from hsflow.multigrid import mg_sweeps

        u, v = mg_sweeps(u, v, ex, ey, et, inv_den, n, cfg)
        return Flow(u, v)
    if cfg.solver == "robust":
        # Charbonnier IRLS (robust.py), jnp on every backend: the sweep is
        # elementwise + 4 shifts, which XLA fuses.
        from hsflow.robust import robust_sweeps

        u, v = robust_sweeps(u, v, ex, ey, et, n, cfg)
        return Flow(u, v)
    if cfg.solver == "sor":
        colors = stencils.color_masks(*u.shape[-2:])

        # sqrt(n)-checkpointed: same arithmetic, O(sqrt(n)) grad memory.
        u, v = stencils.checkpointed_loop(
            lambda uv: stencils.sor_step(
                uv[0], uv[1], ex, ey, et, inv_den, cfg.omega, colors
            ),
            (u, v), n,
        )
        return Flow(u, v)
    if backend == "pallas":
        from hsflow.kernels import jacobi as jacobi_kernels

        u, v = jacobi_kernels.jacobi_sweeps(
            u, v, ex, ey, et, inv_den, n, block_sweeps=cfg.block_sweeps
        )
        return Flow(u, v)

    # sqrt(n)-checkpointed loop: identical sweep sequence, but reverse-mode
    # AD stores only ~sqrt(n) block-boundary states (gradients through a
    # 1080p x 800-sweep solve would otherwise tape tens of GB).
    u, v = stencils.checkpointed_loop(
        lambda uv: stencils.jacobi_step(uv[0], uv[1], ex, ey, et, inv_den),
        (u, v), n,
    )
    return Flow(u, v)


def sweeps_until(
    u: jnp.ndarray,
    v: jnp.ndarray,
    ex: jnp.ndarray,
    ey: jnp.ndarray,
    et: jnp.ndarray,
    inv_den: jnp.ndarray,
    cfg: HSConfig,
    budget: Optional[int] = None,
    run_block=None,
) -> Flow:
    """Solve-to-tolerance (cfg.tol > 0): lax.while_loop over check blocks
    of `block_sweeps` sweeps (1 V-cycle for multigrid), stopping when the
    max u/v update over a block drops below tol or the iteration budget
    (`budget`, default cfg.iters — pyramids pass per-level budgets) is
    exhausted (rounded DOWN to whole blocks — the while_loop trip size is
    trace-static) — entirely on-device, one jit region. The reference's
    loop (SURVEY.md §3.1) can only run a fixed count. On a (B, H, W) stack
    the stop is on the max update over the whole stack.

    `run_block(u, v, n) -> (u, v)` overrides the default block runner
    (`sweeps` on the captured fields); the mesh-sharded multigrid and
    robust solves pass their own, so the stop semantics live here once."""
    iters = cfg.iters if budget is None else budget
    if run_block is None:
        def run_block(uu, vv, nn):
            return sweeps(uu, vv, ex, ey, et, inv_den, nn, cfg)

    if cfg.solver == "multigrid":
        b = 1
    elif cfg.block_sweeps > 0:
        b = cfg.block_sweeps
    else:
        b = 16
    b = min(b, max(iters, 1))
    big = jnp.asarray(jnp.finfo(u.dtype).max, u.dtype)

    def cond(st):
        _, _, k, delta = st
        return jnp.logical_and(k + b <= iters, delta > cfg.tol)

    def body(st):
        uu, vv, k, _ = st
        nu, nv = run_block(uu, vv, b)
        delta = jnp.maximum(
            jnp.abs(nu - uu).max(), jnp.abs(nv - vv).max()
        )
        return (nu, nv, k + b, delta)

    u, v, _, _ = lax.while_loop(cond, body, (u, v, jnp.int32(0), big))
    return Flow(u, v)


def solve_level(
    i1: jnp.ndarray,
    i2: jnp.ndarray,
    cfg: HSConfig,
    iters: int,
    u0: Optional[jnp.ndarray] = None,
    v0: Optional[jnp.ndarray] = None,
) -> Flow:
    """One solve of a 2-D pair with a budget of `iters` sweeps (a fixed
    count when cfg.tol == 0, else the sweeps_until cap), warm-started from
    (u0, v0) when given. `_hs_solve_impl`, the pyramid's level solves and
    the warm video stream all go through here."""
    ex, ey, et, inv_den = precompute(i1, i2, cfg)
    if u0 is not None:
        u = u0.astype(ex.dtype)
        v = v0.astype(ex.dtype)
    else:
        u = jnp.zeros_like(ex)
        v = jnp.zeros_like(ex)
    if cfg.tol > 0:
        return sweeps_until(u, v, ex, ey, et, inv_den, cfg, budget=iters)
    return sweeps(u, v, ex, ey, et, inv_den, iters, cfg)


@partial(jax.jit, static_argnames=("cfg", "with_init"))
def _hs_solve_impl(
    i1: jnp.ndarray,
    i2: jnp.ndarray,
    u0: Optional[jnp.ndarray],
    v0: Optional[jnp.ndarray],
    cfg: HSConfig,
    with_init: bool,
) -> Flow:
    del with_init  # encoded in u0/v0 presence; kept for jit cache keying
    return solve_level(i1, i2, cfg, cfg.iters, u0=u0, v0=v0)


@partial(jax.jit, static_argnames=("cfg", "power_iters"))
def _jacobi_rho_impl(i1, i2, cfg: HSConfig, power_iters: int):
    ex, ey, _, inv_den = precompute(i1, i2, cfg)
    zero_et = jnp.zeros_like(ex)
    key = jax.random.PRNGKey(0)
    u = jax.random.normal(key, ex.shape, ex.dtype)
    v = jax.random.normal(jax.random.fold_in(key, 1), ex.shape, ex.dtype)
    n0 = jnp.sqrt(jnp.sum(u * u) + jnp.sum(v * v))
    tail = max(1, min(10, power_iters // 3))

    def body(k, st):
        uu, vv, acc = st
        nu, nv = stencils.jacobi_step(uu, vv, ex, ey, zero_et, inv_den)
        n = jnp.sqrt(jnp.sum(nu * nu) + jnp.sum(nv * nv))
        # Geometric mean of the last `tail` norm ratios (the iteration
        # matrix is nonsymmetric, so single ratios oscillate).
        acc = acc + jnp.where(k >= power_iters - tail, jnp.log(n), 0.0)
        return (nu / n, nv / n, acc)

    _, _, acc = lax.fori_loop(0, power_iters, body, (u / n0, v / n0, 0.0))
    return jnp.exp(acc / tail)


def tune_omega(
    i1: jnp.ndarray,
    i2: jnp.ndarray,
    cfg: HSConfig = HSConfig(),
    power_iters: int = 300,
) -> float:
    """Estimate the optimal SOR over-relaxation factor for this problem.

    Power-iterates the homogeneous Jacobi update (the et-free linear
    operator whose spectral radius rho governs convergence) on-device,
    then applies the classical optimum omega* = 2 / (1 + sqrt(1 - rho^2))
    [Young 1971, consistently-ordered case — a (validated) heuristic for
    the 4-color 8-neighbor ordering]. One-time cost ~power_iters cheap
    sweeps; the result is quantized to 0.01 so repeated tuning on similar
    frames reuses the jit cache of the subsequent solve. The reference app
    class hard-codes omega; here the solver finds it per problem
    (data-dominated small-alpha problems want far less over-relaxation
    than the Laplacian limit). Measured (128x192, fixed 60 sweeps): at
    alpha=0.1 auto=1.51-1.57 vs grid-best 1.5 — 14x lower EPE than the 1.9
    default; at alpha=1 the converged estimate 1.84 matches 1.9 from 120
    sweeps up (at starvation budgets on stiff problems a hand-picked 1.9
    still edges it — but alpha=1 is multigrid's regime anyway)."""
    import dataclasses

    # rho depends only on (alpha, deriv_variant, dtype); normalize every
    # other field so e.g. checkpoint segments with different iters reuse
    # the compiled power loop.
    key_cfg = dataclasses.replace(
        HSConfig(), alpha=cfg.alpha, deriv_variant=cfg.deriv_variant,
        dtype=cfg.dtype,
    )
    rho = float(_jacobi_rho_impl(i1, i2, key_cfg, power_iters))
    rho = min(rho, 0.9999)
    omega = 2.0 / (1.0 + (1.0 - rho * rho) ** 0.5)
    return round(max(1.0, min(omega, 1.98)), 2)


def hs_solve(
    i1: jnp.ndarray,
    i2: jnp.ndarray,
    cfg: HSConfig = HSConfig(),
    init: Optional[Flow] = None,
) -> Flow:
    """Solve Horn-Schunck optical flow for the frame pair (i1, i2).

    Parity: reference R5 solver loop + R1-R3 kernels (SURVEY.md §2a, §3.1),
    with the behavioral contract of SURVEY.md §2.5. `init` warm-starts u/v
    (used by the pyramid and by checkpoint resume); default zeros (HS81).

    cfg.solver="sor" with cfg.omega == 0 auto-tunes omega first
    (`tune_omega`; one extra jit + host readback of a scalar, then the
    solve runs with the tuned static omega).
    """
    if i1.shape != i2.shape:
        raise ValueError(f"frame shapes differ: {i1.shape} vs {i2.shape}")
    if i1.ndim != 2:
        raise ValueError("hs_solve takes single 2-D grayscale frames; use "
                         "batch.hs_solve_batched for leading batch axes")
    if cfg.solver == "sor" and cfg.omega == 0.0:
        import dataclasses

        cfg = dataclasses.replace(cfg, omega=tune_omega(i1, i2, cfg))
    if init is None:
        return _hs_solve_impl(i1, i2, None, None, cfg, False)
    return _hs_solve_impl(i1, i2, init.u, init.v, cfg, True)
