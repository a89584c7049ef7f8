"""Frame-to-frame ego-motion from dense flow (component N9; driver config 5).

Downstream-SLAM front-end per the north star: fit the 4-parameter 2-D
rigid+zoom motion model to the dense flow field by least squares,

    u(x, y) = tx + s*(x - cx) - w*(y - cy)
    v(x, y) = ty + s*(y - cy) + w*(x - cx)

(tx, ty: translation px/frame; w: roll rate rad/frame; s: zoom rate, the
signature of forward ego-translation). With image-centered coordinates the
normal equations decouple into closed-form moment ratios — four reductions
over the field, each a `psum` when the flow is sharded over mesh axes, so the
estimate runs in-place on the tiled 4K pipeline without gathering the flow
(SURVEY.md §3.5 tail).

Focus of expansion: the fixed point of the model, FOE = center - (tx, ty)/s.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import jax.numpy as jnp
from jax import lax

from hsflow.solver import Flow


class EgoMotion(NamedTuple):
    tx: jnp.ndarray      # mean horizontal translation (px/frame)
    ty: jnp.ndarray      # mean vertical translation (px/frame)
    omega: jnp.ndarray   # roll rate about the optical axis (rad/frame)
    scale: jnp.ndarray   # zoom/expansion rate (1/frame); >0 = approaching
    residual: jnp.ndarray  # RMS model residual (px/frame)

    def focus_of_expansion(self, eps: float = 1e-8):
        """(x, y) image point the flow expands from; meaningful when |scale|
        is well above noise. Relative to the image center used in the fit."""
        return (-self.tx / (self.scale + eps), -self.ty / (self.scale + eps))


def estimate_egomotion(
    flow: Flow,
    center: Optional[tuple[float, float]] = None,
    axis_names: Sequence[str] = (),
    global_offset=None,
) -> EgoMotion:
    """Least-squares 4-parameter ego-motion fit to a dense flow field.

    `center`: reference point for the reported (tx, ty) and the FOE; the fit
    itself always uses centroid-centered coordinates (see body comment).
    `axis_names`: mesh axes to psum moments over when called inside
    shard_map on a spatially-tiled flow; `global_offset` then gives this
    tile's (row0, col0) in the global image so coordinates are global.
    Works on (H, W) fields or any leading batch axes (moments reduce over
    the trailing two axes only).
    """
    u, v = flow.u, flow.v
    h, w = u.shape[-2], u.shape[-1]
    yy = lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xx = lax.broadcasted_iota(jnp.float32, (h, w), 1)
    if global_offset is not None:
        yy = yy + global_offset[0]
        xx = xx + global_offset[1]

    def total(a):
        t = jnp.sum(a, axis=(-2, -1))
        for ax in axis_names:
            t = lax.psum(t, ax)
        return t

    n = total(jnp.ones_like(u))
    # The decoupled closed-form moment ratios below are the least-squares
    # solution only when sum(xb) == sum(yb) == 0, so the fit ALWAYS runs in
    # coordinates centered at the data centroid; an explicit `center` only
    # reparametrizes (tx, ty) afterwards (exact — the model is affine in the
    # center choice) and anchors focus_of_expansion reporting.
    cx = total(jnp.broadcast_to(xx, u.shape)) / n
    cy = total(jnp.broadcast_to(yy, u.shape)) / n
    xb = xx - (cx[..., None, None] if jnp.ndim(cx) else cx)
    yb = yy - (cy[..., None, None] if jnp.ndim(cy) else cy)

    tx = total(u) / n
    ty = total(v) / n
    r2 = total(xb * xb + yb * yb)
    s = total(u * xb + v * yb) / r2
    omega = total(v * xb - u * yb) / r2

    def b(a):
        return a[..., None, None] if jnp.ndim(a) else a

    um = b(tx) + b(s) * xb - b(omega) * yb
    vm = b(ty) + b(s) * yb + b(omega) * xb
    residual = jnp.sqrt(total((u - um) ** 2 + (v - vm) ** 2) / n)
    if center is not None:
        # u = tx + s(x-cx) - w(y-cy) = tx' + s(x-cx') - w(y-cy') with
        # tx' = tx + s(cx'-cx) - w(cy'-cy) (and the rotated analog for ty).
        dx = jnp.float32(center[0]) - cx
        dy = jnp.float32(center[1]) - cy
        tx, ty = tx + s * dx - omega * dy, ty + s * dy + omega * dx
    return EgoMotion(tx, ty, omega, s, residual)
