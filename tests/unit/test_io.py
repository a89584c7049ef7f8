""".flo round-trip (bitwise), unknown-flow masking, PNM image round-trip
(SURVEY.md §4 unit tests; formats per §2.5 FLO)."""

import numpy as np
import pytest

from hsflow.io import flo, images


class TestFlo:
    def test_roundtrip_bitwise(self, tmp_path):
        rng = np.random.default_rng(0)
        flow = rng.normal(size=(17, 23, 2)).astype(np.float32)
        p = tmp_path / "f.flo"
        flo.write_flo(p, flow)
        back = flo.read_flo(p)
        assert back.dtype == np.float32
        assert np.array_equal(back, flow)  # bitwise

    def test_header_layout(self, tmp_path):
        """Magic PIEH, then int32 w, int32 h, little-endian (Middlebury spec)."""
        flow = np.zeros((3, 5, 2), np.float32)
        p = tmp_path / "f.flo"
        flo.write_flo(p, flow)
        raw = p.read_bytes()
        assert raw[:4] == b"PIEH"
        assert np.frombuffer(raw[4:8], "<i4")[0] == 5   # width
        assert np.frombuffer(raw[8:12], "<i4")[0] == 3  # height
        assert len(raw) == 12 + 3 * 5 * 2 * 4

    def test_bad_magic_rejected(self, tmp_path):
        p = tmp_path / "bad.flo"
        p.write_bytes(b"XXXX" + b"\x00" * 20)
        with pytest.raises(ValueError):
            flo.read_flo(p)

    def test_unknown_mask(self):
        flow = np.zeros((4, 4, 2), np.float32)
        flow[1, 2] = (1e10, 0.0)
        flow[3, 0] = (0.0, np.nan)
        mask = flo.unknown_mask(flow)
        assert mask[1, 2] and mask[3, 0]
        assert mask.sum() == 2

    def test_wrong_shape_rejected(self, tmp_path):
        with pytest.raises(ValueError):
            flo.write_flo(tmp_path / "x.flo", np.zeros((4, 4, 3)))


class TestImages:
    def test_pgm_roundtrip(self, tmp_path):
        img = (np.arange(48, dtype=np.float32).reshape(6, 8)) / 47.0
        p = tmp_path / "a.pgm"
        images.save_image(p, img)
        back = images.load_gray(p)
        assert back.shape == (6, 8)
        np.testing.assert_allclose(back, img, atol=1.0 / 255.0)

    def test_ppm_loads_as_luma(self, tmp_path):
        rgb = np.zeros((4, 4, 3), np.float32)
        rgb[..., 1] = 1.0  # pure green
        p = tmp_path / "g.ppm"
        images.save_image(p, rgb)
        gray = images.load_gray(p)
        assert gray.shape == (4, 4)
        np.testing.assert_allclose(gray, 0.587, atol=2.0 / 255.0)

    def test_png_via_pillow(self, tmp_path):
        pytest.importorskip("PIL")
        img = (np.arange(48, dtype=np.float32).reshape(6, 8)) / 47.0
        p = tmp_path / "a.png"
        images.save_image(p, img)
        back = images.load_gray(p)
        np.testing.assert_allclose(back, img, atol=1.0 / 255.0)

    def test_ascii_pgm(self, tmp_path):
        p = tmp_path / "ascii.pgm"
        p.write_text("P2\n# comment\n3 2\n255\n0 128 255\n64 32 16\n")
        img = images.load_gray(p)
        assert img.shape == (2, 3)
        assert img[0, 1] == pytest.approx(128 / 255)
