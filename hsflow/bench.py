"""Benchmark harness (component N15; SURVEY.md §5.5/§6).

Emits the BASELINE metric triplet [BASELINE.json]: Jacobi sweep throughput
(Mpx/s/device), solve latency / frames-per-second at the current device
count, plus achieved-vs-roofline HBM bandwidth. Timing is a warm-up call
synced with `jax.block_until_ready`, then a chain of calls timed with
perf_counter up to a final block_until_ready; optional `jax.profiler.trace`
capture via --profile-dir.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import numpy as np

# THE canonical roofline accounting — every published number derives from
# these constants (root bench.py, chip_smoke.py, PERF.md; do not fork a
# second accounting).
#
# One Jacobi sweep that streams its operands moves 8 arrays per pixel:
# read u, v, Ex, Ey, Et, inv_den + write u, v = 32 B/px in fp32
# (SURVEY.md §3.2), for 25 flops (a fused multiply-add counted as one
# instruction: per field 10 for the separable neighbour average, plus 5
# for the update). At ~0.8 flop/byte the sweep is bound by memory; the
# kernel's temporal blocking (k sweeps per pass) may legitimately exceed
# the streaming bound.
SWEEP_BYTES_PER_PX = 32
SWEEP_OPS_PER_PX = 25

# Published peaks per device_kind. Source: NVIDIA H200 SXM data sheet
# (dense rates, at the full 700 W power limit): 4.8 TB/s HBM3e, 67 TFLOP/s
# fp32 outside the tensor cores. A device missing here is an error, never
# a default.
PEAKS = {
    "NVIDIA H200": {"hbm_gbps": 4800.0, "fp32_tflops": 67.0},
}


def device_peaks(device_kind: str) -> dict:
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add them "
            "to hsflow.bench.PEAKS with their source"
        ) from None


def roofline_gpx_sweeps(device_kind: str, dtype_bytes: int = 4) -> float:
    """Streaming sweep speed-of-light, Gpx*sweeps/s: the lesser of the HBM
    bound and the fp32 compute bound (the HBM bound, on every card listed)."""
    pk = device_peaks(device_kind)
    mem = pk["hbm_gbps"] / (SWEEP_BYTES_PER_PX * dtype_bytes / 4)
    ops = pk["fp32_tflops"] * 1e3 / SWEEP_OPS_PER_PX
    return min(mem, ops)


def _timeit(fn, args, repeats: int) -> float:
    """Seconds per call: a synced warm-up call (compiles), then `repeats`
    chained calls ended by one block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(repeats):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / repeats


def run_bench(
    rc=None,
    shape=(1024, 1280),
    profile_dir: Optional[str] = None,
    repeats: int = 50,
) -> dict:
    import jax
    import jax.numpy as jnp

    from hsflow.config import RunConfig
    from hsflow.pyramid import hs_pyramid
    from hsflow.solver import hs_solve

    rc = rc or RunConfig()
    h, w = shape
    rng = np.random.default_rng(0)
    i1 = jnp.asarray(rng.uniform(0, 1, (h, w)).astype(np.float32))
    i2 = jnp.asarray(rng.uniform(0, 1, (h, w)).astype(np.float32))

    dev = jax.devices()[0]
    ctx = (
        jax.profiler.trace(profile_dir)
        if profile_dir
        else contextlib.nullcontext()
    )
    with ctx:
        dt_solve = _timeit(lambda a, b: hs_solve(a, b, rc.hs), (i1, i2), repeats)
        results_pyr = None
        if rc.pyramid.levels > 1:
            dt_pyr = _timeit(
                lambda a, b: hs_pyramid(a, b, rc.hs, rc.pyramid), (i1, i2), repeats
            )
            results_pyr = {
                "ms_per_frame": round(dt_pyr * 1e3, 3),
                "fps": round(1.0 / dt_pyr, 2),
            }

    px_sweeps = h * w * rc.hs.iters
    gpx_s = px_sweeps / dt_solve / 1e9
    hbm_peak = device_peaks(dev.device_kind)["hbm_gbps"]
    sol_gpx = roofline_gpx_sweeps(dev.device_kind)
    return {
        "device": dev.device_kind,
        "platform": dev.platform,
        "backend": rc.hs.backend,
        "shape": [h, w],
        "iters": rc.hs.iters,
        "sweep_throughput": {
            "mpx_per_s_per_chip": round(gpx_s * 1e3, 1),
            "gpx_sweeps_per_s": round(gpx_s, 3),
            "ms_per_solve": round(dt_solve * 1e3, 3),
            "fps_single_level": round(1.0 / dt_solve, 2),
            "achieved_GBps_lower_bound": round(gpx_s * SWEEP_BYTES_PER_PX, 1),
            "roofline_GBps": hbm_peak,
            "roofline_gpx_sweeps_per_s": round(sol_gpx, 1),
            "fraction_of_roofline": round(gpx_s / sol_gpx, 4),
        },
        "pyramid": results_pyr,
        "n_devices": jax.device_count(),
    }


def run_scaling_bench(rc=None, shape=(512, 640), repeats: int = 30) -> dict:
    """The BASELINE metric triplet tail: frames/s at 1 and N devices.

    1 device: batched video fps (DP). N devices (the cards of one host, or
    the CPU fake backend in tests): DP-batched fps and spatially-tiled
    weak scaling — image area scaled with device count, efficiency =
    T(1 tile alone) / T(N tiles together).
    """
    import jax
    import jax.numpy as jnp

    from hsflow.batch import hs_solve_batched
    from hsflow.config import MeshConfig, RunConfig
    from hsflow.dist import hs_solve_tiled, make_mesh
    from hsflow.dist.mesh import mesh_for_devices
    from hsflow.solver import hs_solve

    rc = rc or RunConfig()
    h, w = shape
    n_dev = jax.device_count()
    rng = np.random.default_rng(0)
    out: dict = {"device": jax.devices()[0].device_kind, "n_devices": n_dev,
                 "shape": [h, w], "iters": rc.hs.iters}

    # fps at 1 chip: batched pairs (config 2 shape)
    batch = 8
    v1 = jnp.asarray(rng.uniform(0, 1, (batch, h, w)).astype(np.float32))
    v2 = jnp.asarray(rng.uniform(0, 1, (batch, h, w)).astype(np.float32))
    dt = _timeit(lambda a, b: hs_solve_batched(a, b, rc.hs), (v1, v2), repeats)
    out["fps_1chip_batched"] = round(batch / dt, 2)

    if n_dev > 1:
        mesh_cfg = mesh_for_devices(n_dev)
        mesh = make_mesh(mesh_cfg)
        # DP scaling: batch split over every device
        vb1 = jnp.asarray(rng.uniform(0, 1, (n_dev * 4, h, w)).astype(np.float32))
        vb2 = jnp.asarray(rng.uniform(0, 1, (n_dev * 4, h, w)).astype(np.float32))
        bmesh = make_mesh(MeshConfig(batch=n_dev, y=1, x=1))
        dt_n = _timeit(
            lambda a, b: hs_solve_batched(a, b, rc.hs, mesh=bmesh), (vb1, vb2), repeats
        )
        out[f"fps_{n_dev}chip_batched"] = round(vb1.shape[0] / dt_n, 2)
        # Weak scaling: one tile-sized image alone vs N tiles tiled
        th, tw = h, w
        big1 = jnp.asarray(
            rng.uniform(0, 1, (th * mesh_cfg.y, tw * mesh_cfg.x)).astype(np.float32)
        )
        big2 = jnp.asarray(
            rng.uniform(0, 1, big1.shape).astype(np.float32)
        )
        i1 = jnp.asarray(rng.uniform(0, 1, (th, tw)).astype(np.float32))
        i2 = jnp.asarray(rng.uniform(0, 1, (th, tw)).astype(np.float32))
        dt_one = _timeit(lambda a, b: hs_solve(a, b, rc.hs), (i1, i2), repeats)
        dt_tiled = _timeit(
            lambda a, b: hs_solve_tiled(
                a, b, rc.hs, mesh=mesh, halo_sweeps=rc.mesh.halo_sweeps
            ),
            (big1, big2),
            repeats,
        )
        out["weak_scaling"] = {
            "mesh": list(mesh_cfg.shape),
            "tile": [th, tw],
            "ms_single_tile": round(dt_one * 1e3, 3),
            "ms_tiled_full": round(dt_tiled * 1e3, 3),
            "efficiency": round(dt_one / dt_tiled, 4),
        }
    return out
