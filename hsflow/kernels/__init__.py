"""GPU kernels (component N5, SURVEY.md §2d — layer T0).

The reference's OpenCL device kernels R1-R3 (SURVEY.md §2a) are plain jnp
(ops/stencils.py) that XLA fuses; the one hand-written kernel is the Jacobi
sweep (jacobi.py), which runs k sweeps per HBM pass instead of the
reference's per-iteration ping-pong buffer round trip.
"""

from hsflow.kernels.jacobi import jacobi_sweeps  # noqa: F401
