"""hsflow — Horn-Schunck dense optical-flow engine for NVIDIA GPUs.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
reference repo `miczi/OpticalFlowHS` (an OpenCL Horn-Schunck implementation;
see SURVEY.md for the reconstructed component inventory — the reference
checkout at /root/reference is an empty mount, so parity citations point at
SURVEY.md sections rather than reference file:line).

Layer map (SURVEY.md §1b):
  T0 kernels/   — the GPU Jacobi-sweep kernel (Pallas, Triton route)
  T1 ops/       — pure-jnp ops + golden NumPy oracle
  T2 solver     — jitted fixed-point Horn-Schunck solve
  T3 pyramid    — coarse-to-fine + warping; batch — data-parallel frame pairs
  T4 dist/      — mesh / halo exchange / tiled multi-device solve
  T5 video, egomotion — streaming pipelines and applications
  T6 io/, metrics, viz, cli — formats, metrics, visualization, entry points
"""

from hsflow.config import (
    HSConfig,
    LKConfig,
    MeshConfig,
    PyramidConfig,
    RunConfig,
    TVL1Config,
)
from hsflow.solver import Flow, hs_solve
from hsflow.pyramid import hs_pyramid
from hsflow.batch import hs_solve_batched
from hsflow.consistency import flow_with_occlusion
from hsflow.lucas_kanade import lk_solve, lk_solve_batched
from hsflow.tvl1 import tvl1_solve, tvl1_solve_batched

__version__ = "0.1.0"

__all__ = [
    "HSConfig",
    "LKConfig",
    "TVL1Config",
    "PyramidConfig",
    "MeshConfig",
    "RunConfig",
    "Flow",
    "hs_solve",
    "hs_solve_batched",
    "hs_pyramid",
    "lk_solve",
    "lk_solve_batched",
    "tvl1_solve",
    "tvl1_solve_batched",
    "flow_with_occlusion",
    "__version__",
]
