"""Bench harness smoke tests (N15) on the CPU backend.

The CPU is not in the published-peaks table, so these tests register
made-up peaks for it: they check the harness's arithmetic, not a device.
"""

import pytest

from hsflow import bench
from hsflow.bench import run_bench, run_scaling_bench
from hsflow.config import HSConfig, PyramidConfig, RunConfig


@pytest.fixture
def cpu_peaks(monkeypatch):
    import jax

    kind = jax.devices()[0].device_kind
    monkeypatch.setitem(bench.PEAKS, kind,
                        {"hbm_gbps": 100.0, "fp32_tflops": 1.0})
    return kind


def test_run_bench_smoke(cpu_peaks):
    rc = RunConfig(hs=HSConfig(iters=4, backend="jnp"), pyramid=PyramidConfig(levels=2))
    r = run_bench(rc, shape=(32, 64), repeats=2)
    st = r["sweep_throughput"]
    assert st["gpx_sweeps_per_s"] > 0
    assert 0 < st["fraction_of_roofline"]
    assert r["pyramid"]["fps"] > 0


def test_run_scaling_bench_smoke():
    rc = RunConfig(hs=HSConfig(iters=4, backend="jnp"))
    r = run_scaling_bench(rc, shape=(16, 32), repeats=2)
    assert r["fps_1chip_batched"] > 0
    assert r["n_devices"] == 8
    assert "fps_8chip_batched" in r
    ws = r["weak_scaling"]
    assert ws["efficiency"] > 0
    assert ws["mesh"] == [1, 2, 4]


def test_run_bench_refuses_unknown_device():
    """Without published peaks for the device there is no roofline to
    report: the harness raises instead of inventing one."""
    rc = RunConfig(hs=HSConfig(iters=2, backend="jnp"))
    with pytest.raises(KeyError, match="no published peaks"):
        run_bench(rc, shape=(8, 16), repeats=1)
