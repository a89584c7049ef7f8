"""Middlebury EPE gate (SURVEY.md §4 rung 6; BASELINE.json target).

Auto-skips when data/middlebury/ is absent (no network on this machine —
SURVEY.md §0); tools/fetch_middlebury.py arms it where egress exists. The
gate: pyramidal HS flow within a sane average-EPE of ground truth on the
classic training pairs, and (when a reference flow dump is ever provided at
data/reference_flows/) <= 0.05 EPE delta vs the reference per BASELINE.json.
"""

import os

import numpy as np
import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
MB_DIR = os.path.join(REPO, "data", "middlebury")
REF_DIR = os.path.join(REPO, "data", "reference_flows")

pytestmark = pytest.mark.skipif(
    not os.path.isdir(MB_DIR),
    reason="data/middlebury/ absent — run tools/fetch_middlebury.py (needs network)",
)


def _sequences():
    img_root = os.path.join(MB_DIR, "other-data")
    gt_root = os.path.join(MB_DIR, "other-gt-flow")
    if not (os.path.isdir(img_root) and os.path.isdir(gt_root)):
        return []
    seqs = []
    for seq in sorted(os.listdir(gt_root)):
        f10 = os.path.join(img_root, seq, "frame10.png")
        f11 = os.path.join(img_root, seq, "frame11.png")
        gt = os.path.join(gt_root, seq, "flow10.flo")
        if all(os.path.exists(p) for p in (f10, f11, gt)):
            seqs.append((seq, f10, f11, gt))
    return seqs


def _solve(f10, f11):
    import jax.numpy as jnp

    from hsflow import HSConfig, PyramidConfig, hs_pyramid
    from hsflow.io.images import load_gray

    i1 = jnp.asarray(load_gray(f10))
    i2 = jnp.asarray(load_gray(f11))
    flow = hs_pyramid(
        i1, i2, HSConfig(alpha=0.1, iters=300), PyramidConfig(levels=4)
    )
    return np.stack([np.asarray(flow.u), np.asarray(flow.v)], axis=-1)


def test_epe_vs_ground_truth():
    from hsflow.io.flo import read_flo
    from hsflow.metrics import epe

    seqs = _sequences()
    if not seqs:
        pytest.skip("middlebury dir present but empty")
    errs = {}
    for seq, f10, f11, gt_path in seqs:
        flow = _solve(f10, f11)
        errs[seq] = epe(flow, read_flo(gt_path))
    mean_epe = float(np.mean(list(errs.values())))
    # Plain pyramidal HS lands around 0.5-1.0 avg EPE on the training set;
    # this guards against regressions, not state of the art.
    assert mean_epe < 1.5, errs


def test_epe_delta_vs_reference_flows():
    """<= 0.05 avg-EPE delta vs reference flow dumps (BASELINE.json:5)."""
    if not os.path.isdir(REF_DIR):
        pytest.skip(
            "no reference flow dumps (reference checkout is an empty mount, "
            "SURVEY.md §0) — drop <seq>.flo files into data/reference_flows/"
        )
    from hsflow.io.flo import read_flo
    from hsflow.metrics import epe

    deltas = {}
    for seq, f10, f11, _ in _sequences():
        ref_path = os.path.join(REF_DIR, f"{seq}.flo")
        if not os.path.exists(ref_path):
            continue
        flow = _solve(f10, f11)
        deltas[seq] = epe(flow, read_flo(ref_path))
    if not deltas:
        pytest.skip("no matching reference flows")
    assert float(np.mean(list(deltas.values()))) <= 0.05, deltas
