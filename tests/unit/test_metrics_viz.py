"""EPE/angular-error hand cases and color-wheel golden pixels (SURVEY.md §4)."""

import numpy as np
import pytest

from hsflow import metrics, viz


class TestEPE:
    def test_exact_match_is_zero(self):
        flow = np.random.default_rng(0).normal(size=(5, 5, 2))
        assert metrics.epe(flow, flow) == 0.0

    def test_hand_case(self):
        gt = np.zeros((2, 2, 2))
        est = np.zeros((2, 2, 2))
        est[0, 0] = (3.0, 4.0)  # error 5 at one of 4 pixels
        assert metrics.epe(est, gt) == pytest.approx(5.0 / 4.0)

    def test_unknown_pixels_excluded(self):
        gt = np.zeros((2, 2, 2))
        gt[1, 1] = (1e10, 1e10)  # unknown
        est = np.zeros((2, 2, 2))
        est[1, 1] = (100.0, 100.0)  # error only on the unknown pixel
        assert metrics.epe(est, gt) == 0.0

    def test_explicit_mask(self):
        gt = np.zeros((1, 2, 2))
        est = np.zeros((1, 2, 2))
        est[0, 0] = (1.0, 0.0)
        mask = np.array([[True, False]])
        assert metrics.epe(est, gt, mask) == pytest.approx(1.0)

    def test_angular_error_zero_for_match(self):
        flow = np.random.default_rng(1).normal(size=(4, 4, 2))
        # arccos near 1 amplifies float noise: 1e-16 in cos -> ~1e-6 degrees.
        assert metrics.angular_error(flow, flow) == pytest.approx(0.0, abs=1e-4)


class TestColorWheel:
    def test_wheel_shape_and_segments(self):
        wheel = viz.make_color_wheel()
        assert wheel.shape == (55, 3)  # RY15+YG6+GC4+CB11+BM13+MR6
        np.testing.assert_array_equal(wheel[0], [255, 0, 0])      # pure red
        np.testing.assert_array_equal(wheel[15], [255, 255, 0])   # pure yellow
        np.testing.assert_array_equal(wheel[21], [0, 255, 0])     # pure green
        np.testing.assert_array_equal(wheel[25], [0, 255, 255])   # pure cyan
        np.testing.assert_array_equal(wheel[36], [0, 0, 255])     # pure blue
        np.testing.assert_array_equal(wheel[49], [255, 0, 255])   # pure magenta

    def test_zero_flow_is_white(self):
        img = viz.flow_to_color(np.zeros((4, 4, 2)), max_flow=1.0)
        np.testing.assert_array_equal(img, 255)

    def test_unit_flow_golden_pixels(self):
        wheel = viz.make_color_wheel()
        # flow (1, 0): atan2(-0, -1) = -pi -> fk = 0 -> wheel[0] (red).
        flow = np.zeros((1, 1, 2))
        flow[0, 0, 0] = 1.0
        img = viz.flow_to_color(flow, max_flow=1.0)
        np.testing.assert_allclose(img[0, 0], wheel[0], atol=1)
        # flow (-1, 0): atan2(0, 1) = 0 -> fk = 27 -> wheel[27] (cyan-blue).
        flow[0, 0, 0] = -1.0
        img = viz.flow_to_color(flow, max_flow=1.0)
        np.testing.assert_allclose(img[0, 0], wheel[27], atol=1)

    def test_unknown_is_black(self):
        flow = np.zeros((2, 2, 2))
        flow[0, 0] = (1e10, 0)
        img = viz.flow_to_color(flow, max_flow=1.0)
        np.testing.assert_array_equal(img[0, 0], 0)

    def test_needle_plot_shapes(self):
        flow = np.ones((32, 48, 2))
        img = viz.needle_plot(flow, step=8)
        assert img.shape == (32, 48, 3)
        assert img.dtype == np.uint8
        assert (img != 255).any()  # something was drawn
