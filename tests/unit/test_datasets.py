"""Dataset loader tests against synthetic fixture trees (no real datasets on
this machine — SURVEY.md §0)."""

import os

import numpy as np
import pytest

from hsflow.data.datasets import (
    MiddleburyDataset,
    SintelDataset,
    evaluate_epe,
)
from hsflow.io.flo import write_flo
from hsflow.io.images import save_image


def _img(seed, h=16, w=24):
    return np.random.default_rng(seed).uniform(0, 1, (h, w)).astype(np.float32)


@pytest.fixture
def middlebury_root(tmp_path):
    root = tmp_path / "mb"
    for seq in ("Grove2", "Urban3"):
        d = root / "other-data" / seq
        d.mkdir(parents=True)
        save_image(d / "frame10.png", _img(1))
        save_image(d / "frame11.png", _img(2))
        g = root / "other-gt-flow" / seq
        g.mkdir(parents=True)
        write_flo(g / "flow10.flo", np.ones((16, 24, 2), np.float32))
    return str(root)


@pytest.fixture
def sintel_root(tmp_path):
    root = tmp_path / "sintel"
    for seq in ("alley_1", "bandage_2"):
        d = root / "training" / "clean" / seq
        d.mkdir(parents=True)
        for k in range(1, 5):
            save_image(d / f"frame_{k:04d}.png", _img(k))
        f = root / "training" / "flow" / seq
        f.mkdir(parents=True)
        for k in range(1, 4):
            write_flo(f / f"frame_{k:04d}.flo", np.full((16, 24, 2), 0.5, np.float32))
    return str(root)


def test_middlebury_layout(middlebury_root):
    ds = MiddleburyDataset(middlebury_root)
    assert len(ds) == 2
    samples = list(ds)
    assert samples[0].seq == "Grove2"
    assert samples[0].frame1.shape == (16, 24)
    assert samples[0].gt_flow.shape == (16, 24, 2)


def test_middlebury_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="fetch_middlebury"):
        MiddleburyDataset(str(tmp_path / "nope"))


def test_sintel_clip_and_pairs(sintel_root):
    ds = SintelDataset(sintel_root)
    assert ds.sequences == ["alley_1", "bandage_2"]
    clip = ds.clip("alley_1")
    assert clip.shape == (4, 16, 24)
    pairs = list(ds.pairs("alley_1"))
    assert len(pairs) == 3
    assert pairs[0].index == 1
    assert pairs[0].gt_flow is not None
    assert len(list(ds)) == 6


def test_sintel_bad_pass(sintel_root):
    with pytest.raises(ValueError, match="render_pass"):
        SintelDataset(sintel_root, render_pass="albedo")


def test_evaluate_epe(middlebury_root):
    ds = MiddleburyDataset(middlebury_root)
    # A fake solver returning the exact GT gives EPE 0; a zero solver gives
    # |(1,1)| = sqrt(2).
    errs = evaluate_epe(ds, lambda a, b: np.ones((*a.shape, 2), np.float32))
    assert all(abs(e) < 1e-6 for e in errs.values())
    errs0 = evaluate_epe(ds, lambda a, b: np.zeros((*a.shape, 2), np.float32))
    assert all(abs(e - np.sqrt(2)) < 1e-5 for e in errs0.values())


def test_evaluate_table(middlebury_root):
    from hsflow.data.datasets import evaluate

    ds = MiddleburyDataset(middlebury_root)
    table = evaluate(ds, lambda a, b: np.ones((*a.shape, 2), np.float32))
    assert "ALL" in table
    assert table["ALL"]["n"] == len(ds)
    for row in table.values():
        assert abs(row["epe"]) < 1e-6
        assert abs(row["ae"]) < 1e-4  # exact direction -> zero angular error
    lim = evaluate(ds, lambda a, b: np.ones((*a.shape, 2), np.float32),
                   limit=1)
    assert lim["ALL"]["n"] == 1


def test_cli_eval(middlebury_root, capsys, tmp_path):
    from hsflow.cli import main

    out = tmp_path / "eval.json"
    rc = main(["eval", "middlebury", str(middlebury_root), "--out", str(out),
               "--cfg.iters", "50", "--cfg.alpha", "0.5",
               "--cfg.backend", "jnp", "--pyramid.levels", "1"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "ALL" in text and "EPE" in text
    import json as _json

    table = _json.loads(out.read_text())
    assert "ALL" in table and table["ALL"]["n"] >= 1
