"""Device-mesh construction (SURVEY.md §2b).

Axes: "batch" (data parallel over frame pairs, P1), "y"/"x" (spatial tiling
of the pixel grid, P2). The four cards of one host are joined all to all by
NVLink, so the mesh shape follows the algorithm (halo perimeter per tile,
batch size), not a topology: devices fill the mesh in order.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

from hsflow.config import MeshConfig


def make_mesh(cfg: MeshConfig = MeshConfig(), devices: Optional[Sequence] = None) -> Mesh:
    """Build a ("batch", "y", "x") Mesh of the first batch*y*x devices."""
    if devices is None:
        devices = jax.devices()
    n = cfg.batch * cfg.y * cfg.x
    if n > len(devices):
        raise ValueError(
            f"mesh {cfg.shape} needs {n} devices, have {len(devices)}"
        )
    dev_array = np.asarray(devices[:n]).reshape(cfg.shape)
    return Mesh(dev_array, cfg.axis_names)


def mesh_for_devices(n: int, batch: int = 1) -> MeshConfig:
    """Factor n devices into a near-square (batch, y, x) spatial tiling."""
    if n % batch != 0:
        raise ValueError(f"{n} devices not divisible by batch={batch}")
    spatial = n // batch
    y = int(np.sqrt(spatial))
    while spatial % y != 0:
        y -= 1
    return MeshConfig(batch=batch, y=y, x=spatial // y)
