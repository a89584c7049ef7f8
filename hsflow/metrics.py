"""Flow metrics (component N12; SURVEY.md §2.5 EPE).

EPE is the judge-facing gate metric [BASELINE.json]: mean over valid pixels of
sqrt((u-u_gt)^2 + (v-v_gt)^2); valid = not marked unknown in the ground truth
(|value| > 1e9 per the Middlebury .flo convention). Angular error follows
Barron et al. 1994 as used by the Middlebury evaluation.

Works on NumPy or JAX arrays (pure jnp-compatible math via the array API).
"""

from __future__ import annotations

import numpy as np


def epe(
    flow: np.ndarray, gt: np.ndarray, valid_mask: np.ndarray | None = None
) -> float:
    """Average endpoint error between (H, W, 2) flow and ground truth."""
    flow = np.asarray(flow, dtype=np.float64)
    gt = np.asarray(gt, dtype=np.float64)
    if flow.shape != gt.shape:
        raise ValueError(f"shape mismatch {flow.shape} vs {gt.shape}")
    if valid_mask is None:
        from hsflow.io.flo import unknown_mask

        valid_mask = ~unknown_mask(gt)
    err = np.sqrt((flow[..., 0] - gt[..., 0]) ** 2 + (flow[..., 1] - gt[..., 1]) ** 2)
    valid = np.asarray(valid_mask, dtype=bool)
    if not valid.any():
        return float("nan")
    return float(err[valid].mean())


def angular_error(
    flow: np.ndarray, gt: np.ndarray, valid_mask: np.ndarray | None = None
) -> float:
    """Mean angular error (degrees) of the space-time direction vectors
    (u, v, 1), per Barron et al. / Middlebury."""
    flow = np.asarray(flow, dtype=np.float64)
    gt = np.asarray(gt, dtype=np.float64)
    if valid_mask is None:
        from hsflow.io.flo import unknown_mask

        valid_mask = ~unknown_mask(gt)
    num = flow[..., 0] * gt[..., 0] + flow[..., 1] * gt[..., 1] + 1.0
    den = np.sqrt(flow[..., 0] ** 2 + flow[..., 1] ** 2 + 1.0) * np.sqrt(
        gt[..., 0] ** 2 + gt[..., 1] ** 2 + 1.0
    )
    cos = np.clip(num / den, -1.0, 1.0)
    ang = np.degrees(np.arccos(cos))
    valid = np.asarray(valid_mask, dtype=bool)
    if not valid.any():
        return float("nan")
    return float(ang[valid].mean())


def hs_energy(i1, i2, flow, alpha: float = 1.0, deriv_variant: str = "hs_cube",
              axis_names=()) -> float:
    """The Horn-Schunck objective the Jacobi iteration minimizes [HS81 eq. 6]:

        E = mean( (Ex u + Ey v + Et)^2 ) + alpha^2 * mean( |grad u|^2 + |grad v|^2 )

    (forward-difference gradients). Monotone non-increase over sweeps is the
    convergence diagnostic (SURVEY.md §3.5 'psum residual'); pass mesh
    `axis_names` to psum the sums when called on sharded tiles inside
    shard_map.
    """
    import jax.numpy as jnp
    from jax import lax

    from hsflow.ops import stencils

    ex, ey, et = stencils.derivatives(
        jnp.asarray(i1, jnp.float32), jnp.asarray(i2, jnp.float32), deriv_variant
    )
    u = jnp.asarray(flow.u, jnp.float32)
    v = jnp.asarray(flow.v, jnp.float32)

    def total(a):
        t = jnp.sum(a)
        for ax in axis_names:
            t = lax.psum(t, ax)
        return t

    data = total((ex * u + ey * v + et) ** 2)

    def grad2(a):
        gx = stencils.shift_left_col(a) - a
        gy = stencils.shift_up_row(a) - a
        return total(gx * gx + gy * gy)

    n = total(jnp.ones_like(u))
    return (data + alpha * alpha * (grad2(u) + grad2(v))) / n


def interior(arr: np.ndarray, margin: int) -> np.ndarray:
    """Crop a margin off every spatial edge — used when comparing against
    analytic GT, whose boundary pixels are undefined under replicate padding."""
    if margin == 0:
        return arr
    return arr[..., margin:-margin, margin:-margin] if arr.ndim == 2 else arr[
        margin:-margin, margin:-margin, ...
    ]
