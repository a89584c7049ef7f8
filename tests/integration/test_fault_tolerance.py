"""Failure detection / recovery (SURVEY.md §5.3 — deliberately thin).

The recovery model: solver state checkpoints every K sweeps; on failure the
launcher restarts and resumes from the last intact checkpoint. Fault
injection here: (a) truncate/corrupt the checkpoint file, (b) corrupt a
tile's halo mid-solve via the dist.halo fault hook. Recovery must reproduce
the uninterrupted result bitwise (checkpoint path) / exactly (tiled restart).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest

from hsflow import HSConfig
from hsflow.checkpoint import hs_solve_checkpointed, save_state
from hsflow.config import MeshConfig
from hsflow.data.synthetic import translation_pair
from hsflow.dist import hs_solve_tiled, make_mesh
from hsflow.dist import halo as halo_mod
from hsflow.solver import hs_solve


def _problem():
    i1, i2, _ = translation_pair(32, 64, 1.0, 0.0, key=21)
    return jnp.asarray(i1), jnp.asarray(i2)


def test_corrupt_checkpoint_detected_and_recovered(tmp_path):
    i1, i2 = _problem()
    cfg = HSConfig(alpha=0.5, iters=16, backend="jnp", checkpoint_every=4)
    p = str(tmp_path / "ck.npz")
    # Write garbage where the checkpoint should be (simulates torn write of a
    # non-atomic writer / disk corruption).
    with open(p, "wb") as f:
        f.write(b"\x00garbage not a zipfile")
    # Detection: load fails -> launcher policy is restart from scratch.
    with pytest.raises(Exception):
        from hsflow.checkpoint import load_state

        load_state(p, cfg)
    os.unlink(p)
    f_rec = hs_solve_checkpointed(i1, i2, cfg, p)
    f_ref = hs_solve(i1, i2, dataclasses.replace(cfg, checkpoint_every=0))
    np.testing.assert_array_equal(np.asarray(f_rec.u), np.asarray(f_ref.u))


def test_stale_checkpoint_resume_still_exact(tmp_path):
    """Losing the newest checkpoint (crash before rename) only costs work:
    resuming from an older one reproduces the exact result."""
    i1, i2 = _problem()
    cfg = HSConfig(alpha=0.5, iters=20, backend="jnp", checkpoint_every=5)
    p = str(tmp_path / "ck.npz")
    seg = hs_solve(i1, i2, dataclasses.replace(cfg, iters=5, checkpoint_every=0))
    save_state(p, seg, 5, cfg)  # as if sweeps 6-20 were lost in a crash
    f_rec = hs_solve_checkpointed(i1, i2, cfg, p, resume=True)
    f_ref = hs_solve(i1, i2, dataclasses.replace(cfg, checkpoint_every=0))
    np.testing.assert_array_equal(np.asarray(f_rec.u), np.asarray(f_ref.u))
    np.testing.assert_array_equal(np.asarray(f_rec.v), np.asarray(f_ref.v))


def test_halo_fault_injection_corrupts_then_restart_recovers():
    """A corrupted halo must actually change the answer (the fault hook is
    live), and a clean restart must reproduce the untiled result."""
    i1, i2 = _problem()
    cfg = HSConfig(alpha=0.5, iters=12, backend="jnp")
    mesh = make_mesh(MeshConfig(batch=1, y=2, x=4))
    ref = hs_solve(i1, i2, cfg)

    try:
        halo_mod.set_fault_hook(lambda t: t + 100.0)
        bad = hs_solve_tiled(i1, i2, cfg, mesh=mesh)
        assert float(jnp.abs(bad.u - ref.u).max()) > 1e-3, (
            "fault hook did not perturb the solve"
        )
    finally:
        halo_mod.set_fault_hook(None)
    good = hs_solve_tiled(i1, i2, cfg, mesh=mesh)
    np.testing.assert_allclose(np.asarray(good.u), np.asarray(ref.u), atol=1e-6)
    np.testing.assert_allclose(np.asarray(good.v), np.asarray(ref.v), atol=1e-6)


def test_checkpoint_from_different_frames_rejected(tmp_path):
    """A stale checkpoint at the same path for a DIFFERENT frame pair with
    the same config must not silently warm-start the wrong solve."""
    i1, i2 = _problem()
    j1, j2, _ = translation_pair(32, 64, 0.0, 1.0, key=99)
    cfg = HSConfig(alpha=0.5, iters=10, backend="jnp", checkpoint_every=5)
    p = str(tmp_path / "ck.npz")
    hs_solve_checkpointed(i1, i2, cfg, p)
    with pytest.raises(ValueError, match="different frame"):
        hs_solve_checkpointed(jnp.asarray(j1), jnp.asarray(j2), cfg, p)


def test_overiterated_checkpoint_rejected(tmp_path):
    """sweeps_done beyond cfg.iters is an error, not a silent return.
    (A config change alters the cfg hash and is caught earlier, so this can
    only arise from a checkpoint whose recorded count exceeds its own
    config's iters — e.g. a hand-written or corrupted state file.)"""
    i1, i2 = _problem()
    cfg = HSConfig(alpha=0.5, iters=20, backend="jnp", checkpoint_every=5)
    p = str(tmp_path / "ck.npz")
    seg = hs_solve(i1, i2, dataclasses.replace(cfg, iters=5, checkpoint_every=0))
    save_state(p, seg, 30, cfg)
    with pytest.raises(ValueError, match="over-iterated"):
        hs_solve_checkpointed(i1, i2, cfg, p)
