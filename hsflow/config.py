"""Config system (SURVEY.md §5.6, component N13).

Frozen, hashable dataclasses so they can be passed as `static_argnums` to
`jax.jit` and cache compilations correctly. The reference app used positional
argv (image paths, alpha, iterations — SURVEY.md §2a R9); here every knob is a
named field with JSON-file and dotted-CLI overrides, and the five driver
configs ship as named presets under configs/.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Tuple

# Derivative estimator variants (SURVEY.md §2.5 eq. D and its note):
#  - "hs_cube": Horn-Schunck 1981 §7 — forward differences averaged over the
#    2x2x2 spatiotemporal cube. The default, per the behavioral contract.
#  - "central": central spatial differences + Et = I2 - I1. The most common
#    later variant; kept behind this flag as the designed-in escape hatch in
#    case the reference's flow fields ever become diffable.
DERIV_VARIANTS = ("hs_cube", "central")

BACKENDS = ("auto", "jnp", "pallas")

# Relaxation schemes:
#  - "jacobi": the reference's scheme (HS81 eq. 12) — the behavioral-parity
#    default; every equivalence/EPE gate runs against it.
#  - "sor": 4-color successive over-relaxation (Gauss-Seidel ordering by
#    colors, omega over-relaxation) — a strict extension for time-to-EPE:
#    ~4x the per-sweep cost, an order of magnitude fewer sweeps at small
#    alpha (ops/stencils.sor_step, tests/unit/test_sor.py).
#  - "multigrid": V-cycles with 4-color GS smoothing (multigrid.py); iters
#    counts V-CYCLES (typical 1-5) — measured ~100x fewer sweep-equivalents
#    than Jacobi to converged EPE at alpha=1 (tests/unit/test_multigrid.py).
#  - "robust": Charbonnier-penalty HS minimized by IRLS / lagged diffusivity
#    (robust.py) — data AND smoothness terms become sqrt(s^2+eps^2), keeping
#    motion boundaries sharp where the quadratic model blurs them; iters
#    counts inner Jacobi sweeps, weights refreeze every robust_update_every.
SOLVERS = ("jacobi", "sor", "multigrid", "robust")


@dataclass(frozen=True)
class HSConfig:
    """Core Horn-Schunck solver configuration (SURVEY.md §2.5)."""

    alpha: float = 1.0          # regularization weight; den = alpha^2 + Ex^2 + Ey^2
    iters: int = 100            # fixed Jacobi iteration count
    dtype: str = "float32"      # compute dtype for the sweep loop
    deriv_variant: str = "hs_cube"
    backend: str = "auto"       # jnp | pallas (the GPU Jacobi kernel) |
                                # auto (the A/B winner on the GPU, else jnp)
    block_sweeps: int = 0       # kernel temporal blocking: sweeps per HBM
                                # pass (0 = auto); also the tol check block
    checkpoint_every: int = 0   # 0 = never; else chunk fori_loop every K sweeps
    solver: str = "jacobi"      # relaxation scheme (SOLVERS)
    omega: float = 1.9          # SOR over-relaxation factor, (0, 2);
                                # 0 = auto-tune per problem (tune_omega)
    robust_eps_d: float = 0.05  # Charbonnier eps of the data term (solver=
                                # "robust"): residuals >> eps_d are outliers
    robust_eps_s: float = 0.05  # Charbonnier eps of the smoothness term:
                                # flow gradients >> eps_s are boundaries
    robust_update_every: int = 20  # sweeps between IRLS weight refreezes
    tol: float = 0.0            # > 0: solve-to-tolerance — stop when the max
                                # u/v update over a check block (block_sweeps
                                # sweeps, or 1 V-cycle) drops below tol px;
                                # iters becomes the budget CAP. 0 = classic
                                # fixed iteration count. Not differentiable
                                # (lax.while_loop); use fixed iters for grads.

    def __post_init__(self):
        if self.deriv_variant not in DERIV_VARIANTS:
            raise ValueError(f"deriv_variant must be one of {DERIV_VARIANTS}")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}")
        if self.solver not in SOLVERS:
            raise ValueError(f"solver must be one of {SOLVERS}")
        if not (self.omega == 0.0 or 0.0 < self.omega < 2.0):
            raise ValueError("omega must be in (0, 2), or 0 for auto-tuned "
                             "(solver.tune_omega; hs_solve only)")
        if self.tol < 0:
            raise ValueError("tol must be >= 0")
        if self.tol > 0 and self.checkpoint_every > 0:
            raise ValueError(
                "tol-based early stopping and checkpoint_every chunking "
                "are mutually exclusive (the chunked loop needs a fixed "
                "sweep schedule)"
            )
        if self.iters < 0:
            raise ValueError("iters must be >= 0")
        if self.robust_eps_d <= 0 or self.robust_eps_s <= 0:
            raise ValueError("robust_eps_d/robust_eps_s must be > 0")
        if self.robust_update_every < 1:
            raise ValueError("robust_update_every must be >= 1")
        if self.block_sweeps < 0:
            raise ValueError("block_sweeps must be >= 0 (0 = auto)")


@dataclass(frozen=True)
class PyramidConfig:
    """Coarse-to-fine pyramid configuration (SURVEY.md §2.5 PYR)."""

    levels: int = 3             # 1 = single-level (no pyramid)
    # 5-tap binomial blur [1,4,6,4,1]/16, applied separably before 2x subsample
    blur: str = "binomial5"
    iters_per_level: Tuple[int, ...] = ()  # empty -> HSConfig.iters at every level
    # Warp lowering: "tiled" = coarse block fetch + local select loop
    # (exact for smooth flows — pyramid.py), "gather" = reference
    # per-element XLA gather, "auto" = tiled.
    warp: str = "auto"
    # Tiled-warp select half-width R: the select loop costs (2R+1)^2
    # combos. 0 = auto — measure the per-tile deviation on device and
    # lax.cond between the R=2 and R=4 loops; exactness-preserving by
    # construction (both loops are exact, and bitwise equal, whenever the
    # cheap one is taken). Fixed values 1..8 pin R for experimentation.
    warp_radius: int = 0

    def __post_init__(self):
        if self.levels < 1:
            raise ValueError("levels must be >= 1")
        if self.warp not in ("auto", "tiled", "gather", "checked"):
            raise ValueError("warp must be auto|tiled|gather|checked")
        if not 0 <= self.warp_radius <= 8:
            raise ValueError("warp_radius must be 0 (auto) or 1..8")
        if self.iters_per_level and len(self.iters_per_level) != self.levels:
            raise ValueError("iters_per_level must match levels")


@dataclass(frozen=True)
class LKConfig:
    """Dense pyramidal Lucas-Kanade configuration (lucas_kanade.py) — the
    second model family; a strict extension beyond the reference's HS."""

    window: int = 15            # odd box-window side for the local least squares
    iters: int = 3              # warp-refine Newton steps per pyramid level
    eps: float = 1e-3           # Tikhonov diagonal regularization of the 2x2
                                # structure tensor (textureless windows)
    dtype: str = "float32"
    max_step: float = 0.0       # > 0: clamp each refinement's |du|,|dv| (px);
                                # 0 = unclamped
    smooth: bool = True         # binomial-blur the flow between refinements
                                # (bounds LK's noise amplification — measured
                                # in lucas_kanade.py::_lk_level)
    # Warp lowering, as PyramidConfig.warp: tiled | gather | auto (= tiled).
    warp: str = "auto"

    def __post_init__(self):
        if self.window < 3 or self.window % 2 == 0:
            raise ValueError("window must be odd and >= 3")
        if self.iters < 1:
            raise ValueError("iters must be >= 1")
        if self.eps <= 0:
            raise ValueError("eps must be > 0")
        if self.max_step < 0:
            raise ValueError("max_step must be >= 0 (0 = unclamped)")
        if self.warp not in ("auto", "tiled", "gather"):
            raise ValueError("warp must be auto|tiled|gather")


@dataclass(frozen=True)
class TVL1Config:
    """TV-L1 flow configuration (tvl1.py) — the third model family (Zach,
    Pock & Bischof 2007): L1 data term + total-variation prior, duality-based
    alternation. A strict extension beyond the reference's quadratic HS."""

    lambda_: float = 0.15       # data-term weight (higher = trust data more),
                                # in the IPOL [0,255]-intensity convention —
                                # tvl1_solve jointly rescales the frame pair
                                # to [0,255] internally, so this default is
                                # correct for ANY input range
    theta: float = 0.3          # quadratic-coupling relaxation parameter
    tau: float = 0.25           # dual ascent step (stable for tau <= 1/4)
    warps: int = 5              # warp-and-relinearize outer steps per level
    warps_per_level: Tuple[int, ...] = ()  # per-level override of `warps`
                                # (coarsest-last, like iters_per_level).
                                # NOTE: pyr.iters_per_level is deliberately
                                # IGNORED by tvl1_solve — it counts HS Jacobi
                                # sweeps, not warp iterations.
    iters: int = 100            # v/u alternations per warp iteration
                                # (measured: 30 leaves a -3 px translation
                                # at EPE 0.56; 100 reaches 0.0000 — the
                                # dual ascent needs ~100 steps to spread
                                # information across a level)
    median: bool = True         # 3x3 median of the flow after each warp
                                # (the standard robustness upgrade, Sun et
                                # al. 2010; pure sort network, no gathers)
    dtype: str = "float32"
    # Warp lowering, as PyramidConfig.warp: tiled | gather | checked |
    # auto. Unlike HS/LK, "auto" = CHECKED here: the tiled
    # warp's exactness contract (per-tile flow deviation <= 4 px from the
    # tile mean) assumes the smooth fields HS produces, and TV-L1's entire
    # purpose is sharp piecewise-constant motion boundaries that can
    # violate it — the checked warp measures the deviation on device and
    # falls back to the reference gather only when the fast path would be
    # inexact. "tiled"/"gather" force either path.
    warp: str = "auto"

    def __post_init__(self):
        if self.lambda_ <= 0 or self.theta <= 0:
            raise ValueError("lambda_ and theta must be > 0")
        if not 0 < self.tau <= 0.25:
            raise ValueError("tau must be in (0, 0.25] (Chambolle stability)")
        if self.warps < 1 or self.iters < 1:
            raise ValueError("warps and iters must be >= 1")
        if any(w < 1 for w in self.warps_per_level):
            raise ValueError("warps_per_level entries must be >= 1")
        if self.warp not in ("auto", "tiled", "gather", "checked"):
            raise ValueError("warp must be auto|tiled|gather|checked")


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh configuration for the distributed tiled solver (SURVEY.md §2b)."""

    batch: int = 1              # data-parallel axis size (frame pairs)
    y: int = 1                  # spatial tiling rows of chips
    x: int = 1                  # spatial tiling cols of chips
    halo_sweeps: int = 1        # exchange an s-px halo every s sweeps (blockwise)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("batch", "y", "x")

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.batch, self.y, self.x)

    def __post_init__(self):
        if min(self.batch, self.y, self.x) < 1:
            raise ValueError("mesh axis sizes must be >= 1")
        if self.halo_sweeps < 1:
            raise ValueError("halo_sweeps must be >= 1")


@dataclass(frozen=True)
class RunConfig:
    """Top-level bundle: everything a CLI/bench invocation needs."""

    hs: HSConfig = HSConfig()
    pyramid: PyramidConfig = PyramidConfig(levels=1)
    mesh: MeshConfig = MeshConfig()
    lk: LKConfig = LKConfig()
    tvl1: TVL1Config = TVL1Config()
    method: str = "hs"          # flow model family: hs | lk | tvl1

    def __post_init__(self):
        if self.method not in ("hs", "lk", "tvl1"):
            raise ValueError("method must be hs|lk|tvl1")


_SECTIONS = {"hs": HSConfig, "pyramid": PyramidConfig, "mesh": MeshConfig,
             "lk": LKConfig, "tvl1": TVL1Config}


def _coerce(cls: type, field_name: str, value: Any) -> Any:
    ftypes = {f.name: f.type for f in dataclasses.fields(cls)}
    if field_name not in ftypes:
        raise KeyError(f"{cls.__name__} has no field '{field_name}'")
    current = getattr(cls(), field_name) if cls is not RunConfig else None
    ftype = ftypes[field_name]
    if isinstance(value, str):
        if ftype in ("int", int):
            return int(value)
        if ftype in ("float", float):
            return float(value)
        if ftype in ("bool", bool):
            if value.lower() in ("1", "true", "yes", "on"):
                return True
            if value.lower() in ("0", "false", "no", "off"):
                return False
            raise ValueError(f"cannot parse boolean from {value!r}")
        if "Tuple" in str(ftype) or isinstance(current, tuple):
            if value.strip() == "":
                return ()
            return tuple(int(v) for v in value.split(","))
    return value


def load_config(path: str | None = None, overrides: dict[str, Any] | None = None) -> RunConfig:
    """Build a RunConfig from an optional JSON file plus dotted overrides.

    JSON layout mirrors the dataclass nesting:
        {"hs": {"alpha": 1.0, "iters": 100}, "pyramid": {"levels": 3}}
    Overrides use dotted keys: {"hs.alpha": 0.5, "mesh.y": 2}.
    """
    data: dict[str, dict[str, Any]] = {k: {} for k in _SECTIONS}
    method = "hs"
    if path is not None:
        with open(path) as f:
            loaded = json.load(f)
        for sect, vals in loaded.items():
            if sect == "method":
                method = vals
                continue
            if sect not in _SECTIONS:
                raise KeyError(f"unknown config section '{sect}'")
            data[sect].update(vals)
    for key, value in (overrides or {}).items():
        if key == "method":
            method = value
            continue
        if "." not in key:
            raise KeyError(f"override '{key}' must be dotted, e.g. hs.alpha")
        sect, field_name = key.split(".", 1)
        if sect not in _SECTIONS:
            raise KeyError(f"unknown config section '{sect}'")
        data[sect][field_name] = _coerce(_SECTIONS[sect], field_name, value)
    return RunConfig(
        hs=HSConfig(**data["hs"]),
        pyramid=PyramidConfig(**data["pyramid"]),
        mesh=MeshConfig(**data["mesh"]),
        lk=LKConfig(**data["lk"]),
        tvl1=TVL1Config(**data["tvl1"]),
        method=method,
    )


def config_hash(cfg) -> str:
    """Stable short hash of any config dataclass (RunConfig, HSConfig, ...);
    tags checkpoints (SURVEY.md §5.4)."""
    import hashlib

    blob = json.dumps(dataclasses.asdict(cfg), sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]
