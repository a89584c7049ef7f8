"""Backend selection (solver.resolve_backend), the shipped deployment
presets, the compile-cache location and the benchmark peaks table."""

import os

import jax
import jax.numpy as jnp
import pytest

from hsflow import solver
from hsflow.config import HSConfig, load_config
from hsflow.kernels import jacobi as jk

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PRESETS = ["c1_single", "c2_video_batch", "c3_pyramid", "c4_hd_streaming",
           "c5_multihost_4k"]


def test_jnp_is_jnp_everywhere():
    assert solver.resolve_backend("jnp") == "jnp"


def test_auto_is_jnp_off_gpu():
    assert jax.default_backend() == "cpu"
    assert solver.resolve_backend("auto") == "jnp"


def test_pallas_off_gpu_is_an_error():
    with pytest.raises(ValueError, match="GPU kernel"):
        solver.resolve_backend("pallas")


def test_pallas_in_interpret_context():
    with jk.interpret_mode():
        assert solver.resolve_backend("pallas") == "pallas"
        # auto never picks the interpreter
        assert solver.resolve_backend("auto") == "jnp"


@pytest.mark.parametrize("backend,expected", [
    ("auto", solver.GPU_AUTO_BACKEND), ("pallas", "pallas"), ("jnp", "jnp"),
])
def test_rules_on_gpu(monkeypatch, backend, expected):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert solver.resolve_backend(backend) == expected


def test_gpu_auto_is_the_ab_winner():
    """The kernel beat plain XLA end to end on the H200 (PERF.md)."""
    assert solver.GPU_AUTO_BACKEND == "pallas"


@pytest.mark.parametrize("entry", ["hs_solve", "hs_pyramid", "batched"])
def test_entry_points_raise_for_pallas_off_gpu(entry):
    from hsflow.batch import hs_solve_batched
    from hsflow.config import PyramidConfig
    from hsflow.pyramid import hs_pyramid

    cfg = HSConfig(iters=3, backend="pallas")
    a = jnp.ones((19, 23), jnp.float32)  # a shape no other test compiles
    with pytest.raises(ValueError, match="GPU kernel"):
        if entry == "hs_solve":
            solver.hs_solve(a, a, cfg)
        elif entry == "hs_pyramid":
            hs_pyramid(a, a, cfg, PyramidConfig(levels=2))
        else:
            hs_solve_batched(a[None], a[None], cfg)


@pytest.mark.parametrize("backend", ["cuda", "mosaic", "triton", ""])
def test_unknown_backend_rejected(backend):
    with pytest.raises(ValueError, match="backend"):
        HSConfig(backend=backend)


@pytest.mark.parametrize("name", PRESETS)
def test_presets_load(name):
    rc = load_config(os.path.join(REPO, "configs", f"{name}.json"))
    assert rc.hs.backend in ("auto", "jnp", "pallas")


def test_hd_streaming_preset_uses_the_ab_choice():
    rc = load_config(os.path.join(REPO, "configs", "c4_hd_streaming.json"))
    assert rc.hs.backend == "auto"


def test_multicard_preset_fits_one_host():
    rc = load_config(os.path.join(REPO, "configs", "c5_multihost_4k.json"))
    assert rc.mesh.batch * rc.mesh.y * rc.mesh.x == 4


def test_compile_cache_honours_env(monkeypatch):
    from hsflow.compile_cache import enable_compile_cache

    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert enable_compile_cache() == "/some/where"
    assert calls == []


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    from hsflow.compile_cache import enable_compile_cache

    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    path = enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_peaks_unknown_device_raises():
    from hsflow.bench import device_peaks, roofline_gpx_sweeps

    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks("cpu")
    with pytest.raises(KeyError):
        roofline_gpx_sweeps("Some Accelerator")


def test_h200_roofline_is_the_hbm_bound():
    from hsflow.bench import roofline_gpx_sweeps

    # 4.8 TB/s / 32 B/px = 150 Gpx*sweeps/s; fp32 bound 67e12/25 is higher
    assert roofline_gpx_sweeps("NVIDIA H200") == pytest.approx(150.0)
    assert roofline_gpx_sweeps("NVIDIA H200", dtype_bytes=2) == pytest.approx(300.0)
