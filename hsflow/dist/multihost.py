"""Multi-process entry (SURVEY.md §2c, §3.5).

On one GPU host, ONE process drives all of the host's cards: no
initialization is needed, jax.devices() lists them all, and the mesh is
built over them (the four cards of a host are joined all to all by
NVLink). Across hosts, run one process per host and give
`jax.distributed.initialize` its cluster explicitly — nothing discovers
it:

    HSFLOW_COORD=10.0.0.2:8476 HSFLOW_NPROC=2 HSFLOW_PROC_ID=$I \
        python -m hsflow.dist.multihost ...

Each process then owns the cards it sees (or those named by
`local_device_ids`), jax.device_count() spans the cluster, and the exact
same `hs_solve_tiled` call used in tests runs with halo legs crossing
processes — there is no separate multi-process code path (that is the point
of shard_map + GSPMD).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def init_multihost(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> None:
    """jax.distributed.initialize from args or HSFLOW_COORD=host:port,
    HSFLOW_NPROC and HSFLOW_PROC_ID. With none of them set this is a
    single-process run and a no-op."""
    import jax

    coordinator = coordinator or os.environ.get("HSFLOW_COORD")
    num_processes = num_processes or _int_env("HSFLOW_NPROC")
    process_id = process_id if process_id is not None else _int_env("HSFLOW_PROC_ID")
    if coordinator is None and num_processes is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def main(argv=None) -> int:
    import numpy as np

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--frame1")
    p.add_argument("--frame2")
    p.add_argument("--shape", default="2160x3840", help="synthetic HxW if no frames")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--halo-sweeps", type=int, default=4)
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--levels", type=int, default=3,
                   help="pyramid levels (1 = single-level tiled solve)")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "jnp", "pallas"],
                   help="per-shard sweep backend; auto = the A/B winner "
                        "on the GPU, jnp elsewhere")
    p.add_argument("-o", "--output", help=".flo output (process 0 only)")
    args = p.parse_args(argv)

    init_multihost()
    import jax
    import jax.numpy as jnp

    from hsflow.config import HSConfig, PyramidConfig
    from hsflow.dist import hs_pyramid_tiled, make_mesh
    from hsflow.dist.mesh import mesh_for_devices
    from hsflow.egomotion import estimate_egomotion

    n = jax.device_count()
    mesh_cfg = mesh_for_devices(n, batch=args.batch)
    mesh = make_mesh(mesh_cfg)
    if jax.process_index() == 0:
        print(f"{jax.process_count()} processes, {n} devices, mesh {mesh_cfg.shape}")

    if args.frame1:
        from hsflow.io.images import load_gray

        i1 = jnp.asarray(load_gray(args.frame1))
        i2 = jnp.asarray(load_gray(args.frame2))
    else:
        h, w = (int(t) for t in args.shape.split("x"))
        rng = np.random.default_rng(0)
        i1 = jnp.asarray(rng.uniform(0, 1, (h, w)).astype(np.float32))
        i2 = jnp.asarray(jnp.roll(i1, 2, axis=1))

    cfg = HSConfig(alpha=args.alpha, iters=args.iters, backend=args.backend)
    pyr = PyramidConfig(levels=args.levels)
    flow = hs_pyramid_tiled(
        i1, i2, cfg, pyr, mesh=mesh, halo_sweeps=args.halo_sweeps
    )
    jax.block_until_ready(flow)
    em = estimate_egomotion(flow)
    if jax.process_index() == 0:
        print(
            f"ego-motion: t=({float(em.tx):+.3f}, {float(em.ty):+.3f}) px/frame, "
            f"omega={float(em.omega):+.5f} rad, scale={float(em.scale):+.5f}, "
            f"residual={float(em.residual):.4f}"
        )
        if args.output:
            from hsflow.io.flo import write_flo

            f = np.stack([np.asarray(flow.u), np.asarray(flow.v)], axis=-1)
            write_flo(args.output, f)
            print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
