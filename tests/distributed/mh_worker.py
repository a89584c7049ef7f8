"""Worker process for the multi-process (multi-"host") distributed test.

Launched by test_multiprocess.py as `python mh_worker.py <pid> <port>`:
2 processes x 4 CPU devices = an 8-device (1, 2, 4) mesh whose "x" axis
spans the process boundary, so the per-sweep halo ppermutes cross processes
(the cross-process legs of SURVEY.md §3.5) via jax.distributed + gloo collectives.
Asserts tiled == local-single-device bitwise.
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.pop("JAX_PLATFORMS", None)
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

pid = int(sys.argv[1])
port = sys.argv[2]
jax.distributed.initialize(
    coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=pid
)
sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..")))

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import multihost_utils  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from hsflow.config import HSConfig, MeshConfig  # noqa: E402
from hsflow.dist import hs_solve_tiled, make_mesh  # noqa: E402
from hsflow.solver import hs_solve  # noqa: E402

assert jax.device_count() == 8, jax.device_count()
assert jax.process_count() == 2, jax.process_count()

mesh = make_mesh(MeshConfig(batch=1, y=2, x=4))
rng = np.random.default_rng(0)
i1 = rng.uniform(0, 1, (32, 64)).astype(np.float32)
i2 = rng.uniform(0, 1, (32, 64)).astype(np.float32)
cfg = HSConfig(alpha=0.5, iters=16, backend="jnp")

sharding = NamedSharding(mesh, P("y", "x"))
g1 = jax.make_array_from_callback((32, 64), sharding, lambda idx: i1[idx])
g2 = jax.make_array_from_callback((32, 64), sharding, lambda idx: i2[idx])
flow = hs_solve_tiled(g1, g2, cfg, mesh=mesh, halo_sweeps=2)
jax.block_until_ready(flow)

local = hs_solve(jnp.asarray(i1), jnp.asarray(i2), cfg)
u_global = multihost_utils.process_allgather(flow.u, tiled=True)
d = float(np.abs(np.asarray(u_global) - np.asarray(local.u)).max())
assert d == 0.0, f"tiled-multiprocess differs from local solve: {d}"

# Sharded coarse-to-fine pyramid across the process boundary (config-5
# flagship): downsample/upsample/warp GSPMD legs + per-level shard_map
# solves, halo ppermutes riding the cross-process links.
from hsflow.config import PyramidConfig  # noqa: E402
from hsflow.dist import hs_pyramid_tiled  # noqa: E402
from hsflow.pyramid import hs_pyramid  # noqa: E402

pyr = PyramidConfig(levels=2)
fp = hs_pyramid_tiled(np.asarray(i1), np.asarray(i2), cfg, pyr,
                      mesh=mesh, halo_sweeps=2)
jax.block_until_ready(fp)
localp = hs_pyramid(jnp.asarray(i1), jnp.asarray(i2), cfg, pyr)
up = multihost_utils.process_allgather(fp.u, tiled=True)
dp = float(np.abs(np.asarray(up) - np.asarray(localp.u)).max())
assert dp <= 5e-6, f"pyramid-multiprocess differs from local: {dp}"

# Kernel-backend leg (interpret mode on CPU): per-shard kernel sweeps
# inside shard_map, exercised across the process boundary, == the jnp
# oracle.
from hsflow.kernels.jacobi import interpret_mode  # noqa: E402

pcfg = HSConfig(alpha=0.5, iters=8, backend="pallas")
with interpret_mode():
    fk = hs_solve_tiled(g1, g2, pcfg, mesh=mesh, halo_sweeps=2)
jax.block_until_ready(fk)
localk = hs_solve(jnp.asarray(i1), jnp.asarray(i2),
                  HSConfig(alpha=0.5, iters=8, backend="jnp"))
uk = multihost_utils.process_allgather(fk.u, tiled=True)
dk = float(np.abs(np.asarray(uk) - np.asarray(localk.u)).max())
assert dk <= 2e-6, f"pallas-tile multiprocess differs from oracle: {dk}"
print(f"MH_WORKER_OK {pid}", flush=True)
