"""Analytic ground-truth generator self-checks (oracle chain rung 1, SURVEY.md §4)."""

import numpy as np
import pytest

from hsflow.data.synthetic import (
    WarpSpec,
    synthetic_pair,
    synthetic_sequence,
    translation_pair,
)


def test_translation_gt_is_constant():
    _, _, gt = translation_pair(16, 20, 1.5, -0.75)
    np.testing.assert_allclose(gt[..., 0], 1.5, atol=1e-6)
    np.testing.assert_allclose(gt[..., 1], -0.75, atol=1e-6)


def test_integer_translation_frames_are_exact_shifts():
    """I2(x, y) = I1(x - tx, y - ty) exactly for integer shifts (analytic
    texture => no interpolation error)."""
    i1, i2, _ = translation_pair(32, 32, 2.0, 1.0, key=3)
    np.testing.assert_allclose(i2[1:, 2:], i1[:-1, :-2], atol=1e-6)


def test_identity_warp_gives_identical_frames():
    i1, i2, gt = synthetic_pair(16, 16, WarpSpec())
    np.testing.assert_allclose(i1, i2, atol=1e-7)
    np.testing.assert_allclose(gt, 0.0, atol=1e-6)


def test_rotation_flow_field():
    """Rotation about the center: flow at center ~ 0, |flow| grows with radius,
    and matches the closed form |2 sin(theta/2)| * r."""
    deg = 4.0
    h = w = 33
    _, _, gt = synthetic_pair(h, w, WarpSpec.rotation(deg), key=1)
    c = (w - 1) / 2
    np.testing.assert_allclose(gt[h // 2, w // 2], 0.0, atol=1e-5)
    r = c  # pixel (center_row, 0) is at radius c
    expected = 2 * np.sin(np.radians(deg) / 2) * r
    assert np.hypot(*gt[h // 2, 0]) == pytest.approx(expected, rel=1e-5)


def test_zoom_flow_points_outward():
    _, _, gt = synthetic_pair(17, 17, WarpSpec.zoom(1.1))
    # Right of center: positive u; below center: positive v.
    assert gt[8, 12, 0] > 0 and abs(gt[8, 12, 1]) < 1e-5
    assert gt[12, 8, 1] > 0


def test_sequence_consistency():
    frames, gt = synthetic_sequence(4, 24, 24, tx=1.0, ty=0.0, key=9)
    assert frames.shape == (4, 24, 24)
    # Consecutive frames are exact 1-px shifts of each other.
    np.testing.assert_allclose(frames[1][:, 1:], frames[0][:, :-1], atol=1e-6)
    np.testing.assert_allclose(gt, [1.0, 0.0])


def test_frames_in_unit_range():
    i1, i2, _ = translation_pair(16, 16, 0.5, 0.5)
    for f in (i1, i2):
        assert f.min() >= 0.0 and f.max() <= 1.0
        assert f.dtype == np.float32
