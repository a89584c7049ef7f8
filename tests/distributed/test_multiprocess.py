"""Multi-process distributed test (SURVEY.md §4 'multi-host without a
cluster', upgraded): TWO OS processes with separate JAX runtimes form one
8-device mesh via jax.distributed.initialize; the spatial "x" axis spans the
process boundary so every halo ppermute crosses processes (gloo — the cross-host
analog). The tiled solve must equal a local single-device solve bitwise."""

import os
import socket
import subprocess
import sys

import pytest

WORKER = os.path.join(os.path.dirname(__file__), "mh_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_tiled_solve_matches_local():
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), port],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            pytest.fail(f"worker timed out:\n{out[-2000:]}")
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-2000:]}"
        assert f"MH_WORKER_OK {pid}" in out, out[-2000:]
