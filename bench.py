"""Jacobi sweep throughput on one GPU: prints ONE JSON line.

Headline: `hs_solve` on a 1080x1920 frame pair, alpha=0.5, 100 sweeps,
`backend="auto"` (the on-card A/B winner), in Gpx*sweeps/s. `vs_baseline` is
the fraction of the fp32 streaming bound (32 B/px/sweep at the card's
published HBM rate, hsflow/bench.py); the kernel's temporal blocking may
exceed it. Timing: one compiling call, then a chain of calls ended by
block_until_ready. Fails when JAX finds no GPU.
"""

import json
import subprocess
import sys
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from hsflow.bench import roofline_gpx_sweeps
    from hsflow.compile_cache import enable_compile_cache
    from hsflow.config import HSConfig
    from hsflow.solver import hs_solve, resolve_backend

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX found {jax.devices()}", file=sys.stderr)
        return 2
    enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    h, w, iters = 1080, 1920, 100
    cfg = HSConfig(alpha=0.5, iters=iters, backend="auto")
    rng = np.random.default_rng(0)
    i1 = jnp.asarray(rng.uniform(0, 1, (h, w)).astype(np.float32))
    i2 = jnp.asarray(rng.uniform(0, 1, (h, w)).astype(np.float32))
    jax.block_until_ready(hs_solve(i1, i2, cfg))  # compile

    n = 50
    t0 = time.perf_counter()
    for _ in range(n):
        flow = hs_solve(i1, i2, cfg)
    jax.block_until_ready(flow)
    dt = (time.perf_counter() - t0) / n

    gpx_sweeps = h * w * iters / dt / 1e9
    sol = roofline_gpx_sweeps(dev.device_kind)
    print(json.dumps({
        "metric": "jacobi_sweep_throughput",
        "value": round(gpx_sweeps, 3),
        "unit": "Gpx*sweeps/s/device",
        "vs_baseline": round(gpx_sweeps / sol, 4),
        "detail": {
            "shape": [h, w],
            "iters": iters,
            "backend": resolve_backend(cfg.backend),
            "ms_per_solve": round(dt * 1e3, 3),
            "platform": dev.platform,
            "device_kind": dev.device_kind,
            "device_count": jax.device_count(),
            "name_and_power_limit": smi,
            "streaming_bound_gpx_sweeps": round(sol, 1),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
