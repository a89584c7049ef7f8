"""CLI (N14) and checkpoint/resume (SURVEY.md §5.4) tests."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest

from hsflow.checkpoint import (
    hs_solve_checkpointed,
    load_state,
    save_state,
)
from hsflow.cli import main as cli_main
from hsflow.config import HSConfig
from hsflow.io.flo import read_flo
from hsflow.io.images import save_image
from hsflow.solver import Flow, hs_solve


@pytest.fixture
def pair_files(tmp_path, small_translation_pair):
    i1, i2, _ = small_translation_pair
    p1 = tmp_path / "f1.pgm"
    p2 = tmp_path / "f2.pgm"
    save_image(p1, i1)
    save_image(p2, i2)
    return str(p1), str(p2)


def test_cli_run_writes_outputs(tmp_path, pair_files):
    p1, p2 = pair_files
    flo = str(tmp_path / "out.flo")
    png = str(tmp_path / "flow.png")
    rc = cli_main(
        ["run", p1, p2, "-o", flo, "--viz", png, "--cfg.iters", "10", "--cfg.alpha", "0.5"]
    )
    assert rc == 0
    f = read_flo(flo)
    assert f.shape == (64, 80, 2)
    assert os.path.getsize(png) > 0


def test_cli_run_kitti_png_output(tmp_path, pair_files):
    """-o out.png routes through the KITTI 48-bit flow encoding, and viz
    reads it back (io.read_flow/write_flow extension dispatch)."""
    p1, p2 = pair_files
    out = str(tmp_path / "flow_kitti.png")
    rc = cli_main(["run", p1, p2, "-o", out, "--cfg.iters", "10"])
    assert rc == 0
    from hsflow.io.kitti import read_flow_png

    f, valid = read_flow_png(out)
    assert f.shape == (64, 80, 2) and valid.all()
    viz = str(tmp_path / "v.png")
    assert cli_main(["viz", out, "-o", viz]) == 0
    assert os.path.getsize(viz) > 0


def test_cli_viz_roundtrip(tmp_path, pair_files):
    p1, p2 = pair_files
    flo = str(tmp_path / "out.flo")
    cli_main(["run", p1, p2, "-o", flo, "--cfg.iters", "5"])
    out = str(tmp_path / "v.png")
    assert cli_main(["viz", flo, "-o", out]) == 0
    assert os.path.getsize(out) > 0
    out2 = str(tmp_path / "needle.png")
    assert cli_main(["viz", flo, "-o", out2, "--needle"]) == 0


def test_cli_video(tmp_path):
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 1, (32, 64)).astype(np.float32)
    fdir = tmp_path / "frames"
    fdir.mkdir()
    for k in range(4):
        save_image(fdir / f"f{k:03d}.pgm", np.roll(base, k, axis=1))
    odir = str(tmp_path / "flows")
    rc = cli_main(["video", str(fdir), "-o", odir, "--cfg.iters", "8", "--chunk", "2"])
    assert rc == 0
    assert len([p for p in os.listdir(odir) if p.endswith(".flo")]) == 3


def test_cli_egomotion(tmp_path, pair_files, capsys):
    """run --egomotion prints the rigid+zoom fit; video --egomotion writes
    per-pair JSON-lines with a sane tx on a pure pan."""
    import json

    p1, p2 = pair_files
    rc = cli_main(["run", p1, p2, "--egomotion", "--cfg.iters", "80",
                   "--cfg.alpha", "0.1"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "egomotion: tx=" in out and "FOE=" in out

    rng = np.random.default_rng(0)
    base = rng.uniform(0, 1, (32, 64)).astype(np.float32)
    fdir = tmp_path / "frames"
    fdir.mkdir()
    for k in range(3):
        save_image(fdir / f"f{k:03d}.pgm", np.roll(base, k, axis=1))
    odir = str(tmp_path / "flows")
    rc = cli_main(["video", str(fdir), "-o", odir, "--egomotion",
                   "--cfg.iters", "60", "--cfg.alpha", "0.1", "--chunk", "2"])
    assert rc == 0
    rows = [json.loads(l) for l in
            open(os.path.join(odir, "egomotion.jsonl"))]
    assert len(rows) == 2
    for r in rows:
        assert 0.5 < r["tx"] < 1.5  # wrap-around pan: 1 px/frame dominant
        assert abs(r["ty"]) < 0.3


def test_cli_occlusion(tmp_path, pair_files, capsys):
    p1, p2 = pair_files
    png = str(tmp_path / "occ.png")
    rc = cli_main(["run", p1, p2, "--occlusion", png, "--cfg.iters", "40",
                   "--cfg.alpha", "0.3"])
    assert rc == 0
    assert os.path.getsize(png) > 0
    assert "% flagged" in capsys.readouterr().out


def test_cli_selftest(capsys):
    rc = cli_main(["selftest", "--shape", "64x80", "--iters", "200"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "OK: all checks passed" in out


def test_cli_info(capsys):
    assert cli_main(["info"]) == 0
    out = capsys.readouterr().out
    assert "jax" in out


def test_cli_config_preset(tmp_path, pair_files):
    p1, p2 = pair_files
    preset = os.path.join(os.path.dirname(__file__), "../../configs/c3_pyramid.json")
    flo = str(tmp_path / "out.flo")
    rc = cli_main(["--config", preset, "run", p1, p2, "-o", flo, "--cfg.iters", "4"])
    assert rc == 0
    assert read_flo(flo).shape == (64, 80, 2)


# -- checkpoint/resume ---------------------------------------------------------


def _problem():
    rng = np.random.default_rng(1)
    i1 = jnp.asarray(rng.uniform(0, 1, (24, 40)).astype(np.float32))
    i2 = jnp.asarray(rng.uniform(0, 1, (24, 40)).astype(np.float32))
    return i1, i2


def test_checkpoint_roundtrip(tmp_path):
    cfg = HSConfig(iters=10)
    u = jnp.ones((4, 5))
    v = jnp.zeros((4, 5))
    p = str(tmp_path / "st.npz")
    save_state(p, Flow(u, v), 7, cfg)
    flow, done = load_state(p, cfg)
    assert done == 7
    np.testing.assert_array_equal(np.asarray(flow.u), np.asarray(u))
    with pytest.raises(ValueError, match="different config"):
        load_state(p, HSConfig(iters=11))


def test_checkpointed_solve_bitwise_equals_straight(tmp_path):
    i1, i2 = _problem()
    cfg = HSConfig(alpha=0.5, iters=20, backend="jnp", checkpoint_every=6)
    p = str(tmp_path / "ck.npz")
    f_ck = hs_solve_checkpointed(i1, i2, cfg, p)
    f_st = hs_solve(i1, i2, dataclasses.replace(cfg, checkpoint_every=0))
    np.testing.assert_array_equal(np.asarray(f_ck.u), np.asarray(f_st.u))
    np.testing.assert_array_equal(np.asarray(f_ck.v), np.asarray(f_st.v))


def test_checkpointed_resume_bitwise(tmp_path):
    """Interrupt after the first segment; resume must finish identically."""
    i1, i2 = _problem()
    cfg = HSConfig(alpha=0.5, iters=20, backend="jnp", checkpoint_every=8)
    p = str(tmp_path / "ck.npz")
    # Simulate an interrupted run: do exactly one 8-sweep segment + save.
    seg = hs_solve(i1, i2, dataclasses.replace(cfg, iters=8, checkpoint_every=0))
    save_state(p, seg, 8, cfg)
    f_resumed = hs_solve_checkpointed(i1, i2, cfg, p, resume=True)
    f_straight = hs_solve(i1, i2, dataclasses.replace(cfg, checkpoint_every=0))
    np.testing.assert_array_equal(np.asarray(f_resumed.u), np.asarray(f_straight.u))
    np.testing.assert_array_equal(np.asarray(f_resumed.v), np.asarray(f_straight.v))


def test_checkpointed_requires_k(tmp_path):
    i1, i2 = _problem()
    with pytest.raises(ValueError, match="checkpoint_every"):
        hs_solve_checkpointed(i1, i2, HSConfig(iters=4), str(tmp_path / "x.npz"))


def test_log_metrics_jsonl(tmp_path):
    from hsflow.logging_util import get_logger, log_metrics
    import json as _json

    p = str(tmp_path / "m" / "metrics.jsonl")
    log_metrics(p, {"metric": "epe", "value": 0.03})
    log_metrics(p, {"metric": "fps", "value": 120})
    lines = [_json.loads(ln) for ln in open(p)]
    assert len(lines) == 2
    assert lines[0]["metric"] == "epe" and "ts" in lines[0]
    assert get_logger().name == "hsflow"


def test_cli_run_tiled_mesh_matches_untiled(tmp_path, pair_files):
    """`hsflow run --mesh.y/--mesh.x` routes through the sharded pyramid and
    must produce the same flow as the single-device run."""
    p1, p2 = pair_files
    a = str(tmp_path / "a.flo")
    b = str(tmp_path / "b.flo")
    args = [p1, p2, "--cfg.iters", "10", "--cfg.alpha", "0.5",
            "--pyramid.levels", "2"]
    assert cli_main(["run", *args, "-o", a]) == 0
    assert cli_main(["run", *args, "-o", b, "--mesh.y", "2", "--mesh.x", "4",
                     "--mesh.halo_sweeps", "2"]) == 0
    fa, fb = read_flo(a), read_flo(b)
    np.testing.assert_allclose(fb, fa, atol=5e-6)


def test_cli_video_warm(tmp_path):
    rng = np.random.default_rng(1)
    base = rng.uniform(0, 1, (32, 64)).astype(np.float32)
    fdir = tmp_path / "frames"
    fdir.mkdir()
    for k in range(4):
        save_image(fdir / f"f{k:03d}.pgm", np.roll(base, k, axis=1))
    odir = str(tmp_path / "flows_warm")
    rc = cli_main(["video", str(fdir), "-o", odir, "--cfg.iters", "8",
                   "--chunk", "2", "--warm"])
    assert rc == 0
    assert len([p for p in os.listdir(odir) if p.endswith(".flo")]) == 3
