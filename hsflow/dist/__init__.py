"""Distribution layer (component N7, SURVEY.md §2b/§2c — layer T4).

Spatial tensor-parallel tiling of the pixel grid across a ("batch", "y", "x")
device mesh with per-sweep ring halo exchange (ppermute) — the stencil analog of
ring attention. The reference is single-device (SURVEY.md §1a); everything
here comes from the north star's multi-chip mandate.
"""

from hsflow.dist.mesh import make_mesh  # noqa: F401
from hsflow.dist.halo import halo_pad  # noqa: F401
from hsflow.dist.tiled_solver import hs_solve_tiled  # noqa: F401
from hsflow.dist.pyramid_tiled import hs_pyramid_tiled  # noqa: F401
