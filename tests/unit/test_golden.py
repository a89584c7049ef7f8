"""Rung 1+2 of the oracle chain (SURVEY.md §4): golden NumPy HS validated
against analytic ground truth and hand-checked stencil arithmetic."""

import numpy as np
import pytest

from hsflow.data.synthetic import WarpSpec, synthetic_pair, translation_pair
from hsflow.metrics import epe, interior
from hsflow.ops import golden


class TestDerivativesHandChecked:
    def test_ramp_x(self):
        # I(x, y) = x/8: Ex = 1/8 except in the clamped last column, Ey = 0.
        h, w = 6, 8
        img = np.tile(np.arange(w, dtype=np.float64) / w, (h, 1))
        ex, ey, et = golden.derivatives_numpy(img, img, "hs_cube")
        np.testing.assert_allclose(ex[:, :-1], 1.0 / w, atol=1e-12)
        np.testing.assert_allclose(ex[:, -1], 0.0, atol=1e-12)  # clamp
        np.testing.assert_allclose(ey, 0.0, atol=1e-12)
        np.testing.assert_allclose(et, 0.0, atol=1e-12)

    def test_ramp_y(self):
        h, w = 8, 6
        img = np.tile((np.arange(h, dtype=np.float64) / h)[:, None], (1, w))
        ex, ey, et = golden.derivatives_numpy(img, img, "hs_cube")
        np.testing.assert_allclose(ey[:-1, :], 1.0 / h, atol=1e-12)
        np.testing.assert_allclose(ey[-1, :], 0.0, atol=1e-12)
        np.testing.assert_allclose(ex, 0.0, atol=1e-12)

    def test_temporal_step(self):
        # I2 = I1 + c: Ex/Ey unchanged-sum halves, Et = c exactly.
        rng = np.random.default_rng(3)
        i1 = rng.uniform(size=(8, 8))
        ex, ey, et = golden.derivatives_numpy(i1, i1 + 0.25, "hs_cube")
        np.testing.assert_allclose(et, 0.25, atol=1e-12)
        ex1, ey1, _ = golden.derivatives_numpy(i1, i1, "hs_cube")
        np.testing.assert_allclose(ex, ex1, atol=1e-12)
        np.testing.assert_allclose(ey, ey1, atol=1e-12)

    def test_cube_manual_pixel(self, tiny_images):
        # Direct transcription of SURVEY.md §2.5 eq. D at one interior pixel.
        i1, i2 = (a.astype(np.float64) for a in tiny_images)
        i, j = 3, 4
        ex, ey, et = golden.derivatives_numpy(i1, i2, "hs_cube")
        ex_ref = 0.25 * (
            i1[i, j + 1] - i1[i, j] + i1[i + 1, j + 1] - i1[i + 1, j]
            + i2[i, j + 1] - i2[i, j] + i2[i + 1, j + 1] - i2[i + 1, j]
        )
        ey_ref = 0.25 * (
            i1[i + 1, j] - i1[i, j] + i1[i + 1, j + 1] - i1[i, j + 1]
            + i2[i + 1, j] - i2[i, j] + i2[i + 1, j + 1] - i2[i, j + 1]
        )
        et_ref = 0.25 * (
            i2[i, j] - i1[i, j] + i2[i + 1, j] - i1[i + 1, j]
            + i2[i, j + 1] - i1[i, j + 1] + i2[i + 1, j + 1] - i1[i + 1, j + 1]
        )
        assert ex[i, j] == pytest.approx(ex_ref, abs=1e-14)
        assert ey[i, j] == pytest.approx(ey_ref, abs=1e-14)
        assert et[i, j] == pytest.approx(et_ref, abs=1e-14)

    def test_central_variant(self, tiny_images):
        i1, i2 = (a.astype(np.float64) for a in tiny_images)
        ex, ey, et = golden.derivatives_numpy(i1, i2, "central")
        np.testing.assert_allclose(et, i2 - i1, atol=1e-14)
        i, j = 3, 4
        assert ex[i, j] == pytest.approx(0.5 * (i1[i, j + 1] - i1[i, j - 1]))
        assert ey[i, j] == pytest.approx(0.5 * (i1[i + 1, j] - i1[i - 1, j]))


class TestNeighborAvg:
    def test_constant_invariant(self):
        u = np.full((7, 9), 3.25)
        np.testing.assert_allclose(golden.neighbor_avg_numpy(u), 3.25, atol=1e-12)

    def test_weights_manual_pixel(self, tiny_images):
        u = tiny_images[0].astype(np.float64)
        i, j = 4, 3
        expect = (
            u[i - 1, j] + u[i, j + 1] + u[i + 1, j] + u[i, j - 1]
        ) / 6.0 + (
            u[i - 1, j - 1] + u[i - 1, j + 1] + u[i + 1, j + 1] + u[i + 1, j - 1]
        ) / 12.0
        assert golden.neighbor_avg_numpy(u)[i, j] == pytest.approx(expect, abs=1e-14)

    def test_replicate_corner(self):
        u = np.arange(12, dtype=np.float64).reshape(3, 4)
        # At (0,0): N4 neighbors are (clamped up)=u00, right=u01, down=u10,
        # (clamped left)=u00; diagonals clamp similarly.
        got = golden.neighbor_avg_numpy(u)[0, 0]
        n4 = (u[0, 0] + u[0, 1] + u[1, 0] + u[0, 0]) / 6.0
        diag = (u[0, 0] + u[0, 1] + u[1, 1] + u[1, 0]) / 12.0
        assert got == pytest.approx(n4 + diag, abs=1e-14)


class TestGoldenConvergence:
    def test_recovers_translation(self):
        i1, i2, gt = translation_pair(48, 64, 1.0, 0.0, key=5)
        u, v = golden.hs_numpy(i1, i2, alpha=0.1, iters=1500)
        flow = np.stack([u, v], axis=-1)
        err = epe(interior(flow, 8), interior(gt, 8))
        assert err < 0.08, f"interior EPE {err}"

    def test_epe_decreases_with_iterations(self):
        i1, i2, gt = translation_pair(48, 64, 1.0, 0.0, key=5)
        errs = []
        for iters in (50, 200, 800):
            u, v = golden.hs_numpy(i1, i2, alpha=0.5, iters=iters)
            errs.append(epe(interior(np.stack([u, v], -1), 8), interior(gt, 8)))
        assert errs[0] > errs[1] > errs[2], errs

    def test_subpixel_diagonal(self):
        i1, i2, gt = synthetic_pair(48, 64, WarpSpec.translation(0.5, -0.5), key=11)
        u, v = golden.hs_numpy(i1, i2, alpha=0.1, iters=1500)
        err = epe(interior(np.stack([u, v], -1), 8), interior(gt, 8))
        assert err < 0.08, f"interior EPE {err}"

    def test_zero_motion_zero_flow(self):
        i1, _, _ = translation_pair(32, 32, 0.0, 0.0, key=2)
        u, v = golden.hs_numpy(i1, i1.copy(), alpha=1.0, iters=100)
        np.testing.assert_allclose(u, 0.0, atol=1e-12)
        np.testing.assert_allclose(v, 0.0, atol=1e-12)
