"""Multi-host entry point (dist/multihost.py) exercised single-process on the
CPU mesh, plus debug-nans hygiene (SURVEY.md §5.2)."""

import jax
import jax.numpy as jnp
import numpy as np

from hsflow.dist.multihost import init_multihost, main


def test_init_multihost_single_process_noop():
    # No HSFLOW_* env: a single-process run, nothing to initialize.
    init_multihost()
    assert jax.process_count() == 1


def test_multihost_main_synthetic(capsys, tmp_path):
    out = str(tmp_path / "flow.flo")
    rc = main(["--shape", "32x64", "--iters", "6", "--halo-sweeps", "2", "-o", out])
    assert rc == 0
    printed = capsys.readouterr().out
    assert "ego-motion" in printed
    from hsflow.io.flo import read_flo

    f = read_flo(out)
    assert f.shape[2] == 2
    assert np.isfinite(f).all()


def test_solver_clean_under_debug_nans():
    """jax_debug_nans raises on any NaN produced inside jit — the solver and
    pyramid must be NaN-free on real inputs (division guards etc.)."""
    from hsflow import HSConfig, PyramidConfig, hs_pyramid, hs_solve
    from hsflow.data.synthetic import translation_pair

    i1, i2, _ = translation_pair(32, 64, 1.0, 0.5, key=2)
    jax.config.update("jax_debug_nans", True)
    try:
        f = hs_solve(jnp.asarray(i1), jnp.asarray(i2), HSConfig(alpha=0.5, iters=8))
        fp = hs_pyramid(
            jnp.asarray(i1), jnp.asarray(i2),
            HSConfig(alpha=0.5, iters=8), PyramidConfig(levels=2),
        )
        assert np.isfinite(np.asarray(f.u)).all()
        assert np.isfinite(np.asarray(fp.u)).all()
    finally:
        jax.config.update("jax_debug_nans", False)
