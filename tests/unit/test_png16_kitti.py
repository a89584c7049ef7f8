"""16-bit PNG codec + KITTI flow format (io/png16.py, io/kitti.py).

Oracle chain: the pure-numpy codec round-trips bit-exactly; the native
OpenCV path (when libhsio is built with codecs) must agree with it in both
directions; the KITTI encode/decode round-trips flow at the format's 1/64 px
quantization with the valid mask preserved.
"""

import os
import struct
import zlib

import numpy as np
import pytest

from hsflow.io import kitti, png16


def _rand_img(rng, h, w, ch=3, dtype=np.uint16):
    hi = 65536 if dtype == np.uint16 else 256
    shape = (h, w) if ch == 1 else (h, w, ch)
    return rng.integers(0, hi, shape).astype(dtype)


class TestPng16:
    def test_roundtrip_rgb16(self, tmp_path):
        rng = np.random.default_rng(0)
        img = _rand_img(rng, 37, 53)
        p = tmp_path / "a.png"
        png16.write_png(p, img)
        assert np.array_equal(png16.read_png(p), img)

    def test_roundtrip_gray16(self, tmp_path):
        rng = np.random.default_rng(1)
        img = _rand_img(rng, 16, 31, ch=1)
        p = tmp_path / "g.png"
        png16.write_png(p, img)
        assert np.array_equal(png16.read_png(p), img)

    def test_roundtrip_rgb8(self, tmp_path):
        rng = np.random.default_rng(2)
        img = _rand_img(rng, 9, 13, dtype=np.uint8)
        p = tmp_path / "b.png"
        png16.write_png(p, img)
        assert np.array_equal(png16.read_png(p), img)

    def test_all_filter_types_decode(self, tmp_path):
        """Hand-build a PNG whose five scanlines use filters 0..4 and check
        against a reference unfilter implementation (filters act on bytes,
        per the PNG spec §9)."""
        rng = np.random.default_rng(3)
        h, w, bpp = 5, 11, 6  # 16-bit RGB
        stride = w * bpp
        recon = rng.integers(0, 256, (h, stride)).astype(np.uint8)
        raw = bytearray()
        for y in range(h):
            ft = y % 5
            raw.append(ft)
            prev = recon[y - 1] if y else np.zeros(stride, np.uint8)
            line = recon[y].astype(np.int32)
            for c in range(stride):
                a = int(recon[y, c - bpp]) if c >= bpp else 0
                b = int(prev[c])
                cc = int(prev[c - bpp]) if c >= bpp else 0
                if ft == 0:
                    pred = 0
                elif ft == 1:
                    pred = a
                elif ft == 2:
                    pred = b
                elif ft == 3:
                    pred = (a + b) // 2
                else:
                    p = a + b - cc
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
                raw.append((line[c] - pred) & 0xFF)
        ihdr = struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 0)

        def chunk(tag, payload):
            return (struct.pack(">I", len(payload)) + tag + payload
                    + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

        p = tmp_path / "filters.png"
        p.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                      + chunk(b"IDAT", zlib.compress(bytes(raw)))
                      + chunk(b"IEND", b""))
        img = png16.read_png(p)
        expect = recon.reshape(h, w, 3, 2).astype(np.uint16)
        expect = (expect[..., 0] << 8) | expect[..., 1]
        assert np.array_equal(img, expect)

    def test_rejects_non_png(self, tmp_path):
        p = tmp_path / "x.png"
        p.write_bytes(b"hello world")
        with pytest.raises(ValueError, match="not a PNG"):
            png16.read_png(p)


class TestNativePng16:
    @pytest.fixture
    def native(self):
        from hsflow.io import native

        if not native.available() or not (native.codecs() & native.CODEC_OPENCV):
            pytest.skip("libhsio with OpenCV codecs not built")
        return native

    def test_native_vs_python_both_directions(self, native, tmp_path):
        rng = np.random.default_rng(4)
        img = _rand_img(rng, 29, 41)
        pn = tmp_path / "n.png"
        pp = tmp_path / "p.png"
        assert native.write_png16(str(pn), img)
        png16.write_png(pp, img)
        assert np.array_equal(native.read_png16(str(pn)), img)
        assert np.array_equal(png16.read_png(pn), img)       # py reads cv png
        assert np.array_equal(native.read_png16(str(pp)), img)  # cv reads py png


class TestKitti:
    def test_roundtrip_quantized(self, tmp_path):
        rng = np.random.default_rng(5)
        h, w = 17, 23
        # flow on the format's 1/64 px grid round-trips exactly
        flow = rng.integers(-320 * 64, 320 * 64, (h, w, 2)) / 64.0
        flow = flow.astype(np.float32)
        valid = rng.uniform(size=(h, w)) > 0.3
        flow[~valid] = 0.0
        p = tmp_path / "k.png"
        kitti.write_flow_png(p, flow, valid)
        back, vback = kitti.read_flow_png(p)
        assert np.array_equal(vback, valid)
        assert np.array_equal(back, flow)

    def test_quantization_error_bound(self, tmp_path):
        rng = np.random.default_rng(6)
        flow = rng.uniform(-10, 10, (9, 11, 2)).astype(np.float32)
        p = tmp_path / "q.png"
        kitti.write_flow_png(p, flow)
        back, valid = kitti.read_flow_png(p)
        assert valid.all()
        assert np.abs(back - flow).max() <= 0.5 / 64 + 1e-6

    def test_clips_out_of_range(self, tmp_path):
        flow = np.full((4, 4, 2), 1e4, np.float32)
        p = tmp_path / "c.png"
        kitti.write_flow_png(p, flow)
        back, _ = kitti.read_flow_png(p)
        assert np.all(back <= 512.0)
        assert np.all(back >= 511.0)

    def test_dataset_loader(self, tmp_path):
        """Synthetic KITTI tree -> loader yields pairs with sparse GT marked
        via the Middlebury unknown sentinel."""
        from hsflow.data.datasets import KittiDataset
        from hsflow.io.flo import unknown_mask
        from hsflow.io.images import save_image

        img_dir = tmp_path / "training" / "image_2"
        gt_dir = tmp_path / "training" / "flow_occ"
        os.makedirs(img_dir)
        os.makedirs(gt_dir)
        rng = np.random.default_rng(7)
        h, w = 12, 20
        for k in range(2):
            for t in (10, 11):
                save_image(
                    str(img_dir / f"{k:06d}_{t}.png"),
                    rng.uniform(size=(h, w)).astype(np.float32),
                )
        flow = rng.integers(-64, 64, (h, w, 2)) / 64.0
        valid = rng.uniform(size=(h, w)) > 0.5
        flow[~valid] = 0.0
        kitti.write_flow_png(gt_dir / "000000_10.png", flow, valid)

        ds = KittiDataset(str(tmp_path))
        samples = list(ds)
        assert [s.seq for s in samples] == ["000000", "000001"]
        s0 = samples[0]
        assert s0.frame1.shape == (h, w)
        assert np.array_equal(unknown_mask(s0.gt_flow), ~valid)
        assert np.allclose(s0.gt_flow[valid], flow[valid])
        assert samples[1].gt_flow is None

    def test_epe_respects_valid_mask(self, tmp_path):
        """metrics.epe over KITTI-loaded GT scores only valid pixels."""
        from hsflow.metrics import epe

        h, w = 8, 8
        gt = np.zeros((h, w, 2), np.float32)
        valid = np.zeros((h, w), bool)
        valid[:4] = True
        gt[:4] = 1.0
        p = tmp_path / "m.png"
        kitti.write_flow_png(p, gt, valid)
        flow_gt, vmask = kitti.read_flow_png(p)
        est = np.ones((h, w, 2), np.float32)  # exact on valid, wrong on invalid
        assert epe(est, flow_gt, vmask) == 0.0
