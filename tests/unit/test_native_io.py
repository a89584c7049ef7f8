"""libhsio native IO tests: builds the shared library with the in-tree
Makefile and asserts equivalence with the pure-Python IO paths."""

import numpy as np
import pytest

from hsflow.io import flo as pyflo
from hsflow.io import images as pyimages
from hsflow.io import native


@pytest.fixture(scope="session")
def hsio():
    if not native.build():
        pytest.skip("no C++ toolchain available to build libhsio")
    if not native.available():
        pytest.skip("libhsio built but failed to load")
    return native


def test_load_gray_matches_python_pgm(hsio, tmp_path):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (37, 53)).astype(np.float32)
    p = str(tmp_path / "t.pgm")
    pyimages.save_image(p, img)
    a = hsio.load_gray(p)
    b = pyimages.load_gray(p)
    np.testing.assert_array_equal(a, b)
    assert a.dtype == np.float32


def test_load_gray_matches_python_ppm_color(hsio, tmp_path):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (16, 24, 3)).astype(np.float32)
    p = str(tmp_path / "t.ppm")
    pyimages.save_image(p, img)
    a = hsio.load_gray(p)
    b = pyimages.load_gray(p)
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_flo_roundtrip_cross_implementation(hsio, tmp_path):
    rng = np.random.default_rng(2)
    f = rng.normal(size=(19, 31, 2)).astype(np.float32)
    p_native = str(tmp_path / "n.flo")
    p_python = str(tmp_path / "p.flo")
    hsio.write_flo(p_native, f)
    pyflo.write_flo(p_python, f)
    with open(p_native, "rb") as a, open(p_python, "rb") as b:
        assert a.read() == b.read(), "native and python .flo bytes differ"
    np.testing.assert_array_equal(hsio.read_flo(p_python), f)
    np.testing.assert_array_equal(pyflo.read_flo(p_native), f)


def test_stream_frames_order_and_content(hsio, tmp_path):
    rng = np.random.default_rng(3)
    paths = []
    want = []
    for k in range(12):
        img = rng.uniform(0, 1, (20, 32)).astype(np.float32)
        p = str(tmp_path / f"f{k:03d}.pgm")
        pyimages.save_image(p, img)
        paths.append(p)
        want.append(pyimages.load_gray(p))
    got = list(hsio.stream_frames(paths, n_threads=3, prefetch=4))
    assert len(got) == 12
    for k in range(12):
        np.testing.assert_array_equal(got[k], want[k])


def test_stream_frames_empty(hsio):
    assert list(hsio.stream_frames([])) == []


def test_load_gray_missing_file_raises(hsio):
    with pytest.raises(IOError):
        hsio.load_gray("/nonexistent/x.pgm")


def test_stream_frames_mixed_sizes(hsio, tmp_path):
    """Frames of different sizes: the loader reports dims per frame, the
    binding grows its buffer, and no frame is lost or misread."""
    rng = np.random.default_rng(9)
    sizes = [(20, 32), (48, 64), (12, 16), (48, 64)]
    paths, want = [], []
    for k, (h, w) in enumerate(sizes):
        img = rng.uniform(0, 1, (h, w)).astype(np.float32)
        p = str(tmp_path / f"m{k}.pgm")
        pyimages.save_image(p, img)
        paths.append(p)
        want.append(pyimages.load_gray(p))
    got = list(hsio.stream_frames(paths, n_threads=2, prefetch=3))
    assert [g.shape for g in got] == sizes
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(g, wv)


def test_stream_frames_corrupt_frame_reports_in_order(hsio, tmp_path):
    """A corrupt frame mid-stream errors only when reached; earlier frames
    are delivered intact."""
    rng = np.random.default_rng(10)
    paths, want = [], []
    for k in range(5):
        img = rng.uniform(0, 1, (16, 24)).astype(np.float32)
        p = str(tmp_path / f"c{k}.pgm")
        pyimages.save_image(p, img)
        paths.append(p)
        want.append(pyimages.load_gray(p))
    with open(paths[3], "wb") as f:
        f.write(b"P5\n24 16\n255\n_too_short")
    got = []
    with pytest.raises(IOError):
        for fr in hsio.stream_frames(paths, n_threads=3, prefetch=5):
            got.append(fr)
    assert len(got) == 3
    for g, wv in zip(got, want[:3]):
        np.testing.assert_array_equal(g, wv)


def test_crlf_pnm_header_decodes_exactly(hsio, tmp_path):
    """Windows-written PNM: CRLF after maxval must not shift pixel data."""
    rng = np.random.default_rng(7)
    px = (rng.uniform(0, 255, (9, 13))).astype(np.uint8)
    p = str(tmp_path / "crlf.pgm")
    with open(p, "wb") as f:
        f.write(b"P5\r\n13 9\r\n255\r\n" + px.tobytes())
    a = hsio.load_gray(p)
    np.testing.assert_allclose(a, px.astype(np.float32) / 255.0, atol=1e-7)


def test_corrupt_flo_dims_rejected(hsio, tmp_path):
    """Negative / absurd dimensions in a .flo header are a clean format
    error, not a huge allocation downstream."""
    import struct

    for w, h in ((-3, 8), (8, -1), (2_000_000, 2), (0, 0)):
        p = str(tmp_path / f"bad_{w}_{h}.flo")
        with open(p, "wb") as f:
            f.write(struct.pack("<fii", 202021.25, w, h))
        with pytest.raises(Exception):
            hsio.read_flo(p)


@pytest.fixture(scope="session")
def hsio_cv(hsio):
    if not (hsio.codecs() & hsio.CODEC_OPENCV):
        pytest.skip("libhsio built without the OpenCV codecs")
    return hsio


def test_png_gray_matches_python(hsio_cv, tmp_path):
    """Native PNG decode (grayscale) == PIL path, bit-for-bit scaling."""
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1, (21, 33)).astype(np.float32)
    p = str(tmp_path / "g.png")
    pyimages.save_image(p, img)
    a = hsio_cv.load_gray(p)
    b = pyimages.load_gray(p)
    np.testing.assert_allclose(a, b, atol=1e-6)
    assert a.shape == (21, 33)


def test_png_color_matches_python(hsio_cv, tmp_path):
    """Native PNG decode (RGB) == PIL path: identical float BT.601 luma."""
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (14, 19, 3)).astype(np.float32)
    p = str(tmp_path / "c.png")
    pyimages.save_image(p, img)
    a = hsio_cv.load_gray(p)
    b = pyimages.load_gray(p)
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_png_probe_header_only(hsio_cv, tmp_path):
    """hsio_probe reads PNG dimensions from the IHDR without a full decode."""
    import ctypes

    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, (9, 31)).astype(np.float32)
    p = str(tmp_path / "p.png")
    pyimages.save_image(p, img)
    lib = hsio_cv._load()
    w = ctypes.c_int()
    h = ctypes.c_int()
    assert lib.hsio_probe(p.encode(), ctypes.byref(w), ctypes.byref(h)) == 0
    assert (w.value, h.value) == (31, 9)


def test_stream_frames_over_png_dir(hsio_cv, tmp_path):
    """The threaded prefetch loader streams PNG directories (config 4 no
    longer falls back to synchronous Python decode for PNG)."""
    rng = np.random.default_rng(5)
    paths = []
    ref = []
    for k in range(6):
        img = rng.uniform(0, 1, (12, 16)).astype(np.float32)
        p = str(tmp_path / f"f_{k:03d}.png")
        pyimages.save_image(p, img)
        paths.append(p)
        ref.append(pyimages.load_gray(p))
    got = list(hsio_cv.stream_frames(paths, n_threads=3, prefetch=2))
    assert len(got) == 6
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=1e-6)


@pytest.fixture(scope="session")
def hsio_video(hsio):
    if not native.video_available():
        pytest.skip("libhsio built without OpenCV videoio")
    return native


def _smooth_frames(t=8, h=48, w=64):
    """Low-frequency frames (lossy codecs keep these within ~2/255)."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    return [
        (0.5 + 0.3 * np.sin(2 * np.pi * (xs / 32.0 + 0.1 * k))
         * np.cos(2 * np.pi * ys / 24.0)).astype(np.float32)
        for k in range(t)
    ]


def test_video_write_read_roundtrip(hsio_video, tmp_path):
    frames = _smooth_frames()
    path = str(tmp_path / "clip.avi")
    n = native.write_video(path, frames, fps=10.0, fourcc="MJPG")
    assert n == len(frames)
    w, h, fps, nf = native.video_info(path)
    assert (w, h) == (64, 48)
    assert nf in (-1, len(frames))
    got = list(native.stream_video(path))
    assert len(got) == len(frames)
    for a, b in zip(got, frames):
        assert a.shape == b.shape
        # MJPG is lossy; gray->BGR->gray is exact, DCT is not
        assert float(np.abs(a - b).max()) < 0.03


def test_video_feeds_flow_stream(hsio_video, tmp_path):
    """mp4/avi ingestion composes with the streaming solver: a panning
    synthetic clip through write->decode->flow_stream recovers the pan."""
    import jax.numpy as jnp

    from hsflow.config import HSConfig
    from hsflow.video import flow_stream

    h, w, t = 64, 96, 5
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = [
        (0.5 + 0.25 * np.sin(2 * np.pi * (xs - 1.0 * k) / 24.0)
         + 0.15 * np.cos(2 * np.pi * ys / 20.0)).astype(np.float32)
        for k in range(t)
    ]
    path = str(tmp_path / "pan.avi")
    native.write_video(path, frames, fps=10.0, fourcc="MJPG")
    decoded = native.stream_video(path)
    flows = list(flow_stream(decoded, HSConfig(alpha=0.1, iters=300,
                                               backend="jnp"), chunk=2))
    u = jnp.concatenate([f.u for f in flows])
    assert u.shape[0] == t - 1
    # interior mean u ~ +1 px/frame pan
    assert abs(float(u[:, 8:-8, 8:-8].mean()) - 1.0) < 0.15


def test_video_bad_source(hsio_video, tmp_path):
    with pytest.raises(IOError, match="cannot open"):
        native.video_info(str(tmp_path / "missing.mp4"))


def test_cli_video_file_to_viz_video(hsio_video, tmp_path):
    """End-to-end CLI: video-file input -> flows + one viz video output."""
    from hsflow.cli import main

    h, w, t = 48, 64, 4
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = [
        (0.5 + 0.3 * np.sin(2 * np.pi * (xs - k) / 24.0)).astype(np.float32)
        for k in range(t)
    ]
    clip = str(tmp_path / "in.avi")
    native.write_video(clip, frames, fps=10.0, fourcc="MJPG")
    outdir = str(tmp_path / "flows")
    vid = str(tmp_path / "flowviz.avi")
    rc = main(["video", clip, "-o", outdir, "--viz-video", vid,
               "--chunk", "2", "--cfg.iters", "20"])
    assert rc == 0
    import os as _os

    flos = [p for p in _os.listdir(outdir) if p.endswith(".flo")]
    assert len(flos) == t - 1
    wv, hv, _, _ = native.video_info(vid)
    assert (wv, hv) == (w, h)
    assert len(list(native.stream_video(vid))) == t - 1


def test_unloadable_library_falls_back_to_python(monkeypatch, tmp_path):
    """A libhsio.so that cannot be loaded here (e.g. linked against an
    OpenCV this host lacks) means "no native library", not a crash."""
    bad = tmp_path / "libhsio.so"
    bad.write_bytes(b"not a shared object")
    monkeypatch.setattr(native, "_LIB_PATH", str(bad))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_tried", False)
    assert not native.available()
