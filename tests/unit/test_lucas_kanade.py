"""Dense pyramidal Lucas-Kanade (lucas_kanade.py) — the second model family.

Oracle chain per SURVEY.md §4: analytic-GT synthetic pairs (rung 1) are the
foundation; LK must recover known translations in the interior. Plus a
hand-checkable box_sum unit test and batched == loop-of-singles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hsflow import LKConfig, PyramidConfig, lk_solve, lk_solve_batched
from hsflow.data.synthetic import translation_pair
from hsflow.lucas_kanade import box_sum
from hsflow.metrics import epe, interior


def test_box_sum_matches_numpy():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (17, 23)).astype(np.float32)
    w = 5
    out = np.asarray(box_sum(jnp.asarray(a), w))
    # NumPy oracle: zero-padded window sum
    pad = np.pad(a, w // 2)
    ref = np.zeros_like(a)
    for dy in range(w):
        for dx in range(w):
            ref += pad[dy : dy + a.shape[0], dx : dx + a.shape[1]]
    np.testing.assert_allclose(out, ref, atol=1e-4)


@pytest.mark.parametrize("du,dv", [(1.0, 0.0), (0.0, 1.0), (0.7, -0.4)])
def test_recovers_small_translation(du, dv):
    i1, i2, gt = translation_pair(96, 128, du, dv, key=3)
    flow = lk_solve(jnp.asarray(i1), jnp.asarray(i2), LKConfig(iters=3))
    f = np.stack([np.asarray(flow.u), np.asarray(flow.v)], -1)
    assert float(epe(interior(f, 12), interior(gt, 12))) < 0.08


def test_pyramid_handles_large_displacement():
    # 5 px shift: outside a single-level linearization's reach, easy for
    # 3 levels (the same argument as the HS pyramid test).
    i1, i2, gt = translation_pair(128, 192, 5.0, 0.0, key=7)
    single = lk_solve(jnp.asarray(i1), jnp.asarray(i2), LKConfig(iters=4))
    pyr = lk_solve(
        jnp.asarray(i1), jnp.asarray(i2), LKConfig(iters=4),
        PyramidConfig(levels=3),
    )
    e1 = float(
        epe(
            interior(np.stack([np.asarray(single.u), np.asarray(single.v)], -1), 16),
            interior(gt, 16),
        )
    )
    e3 = float(
        epe(
            interior(np.stack([np.asarray(pyr.u), np.asarray(pyr.v)], -1), 16),
            interior(gt, 16),
        )
    )
    assert e3 < 0.25
    assert e3 < e1 / 4


def test_batched_matches_singles():
    pairs = [translation_pair(64, 96, d, 0.3, key=k) for k, d in
             enumerate((0.5, 1.0, -0.8))]
    i1 = jnp.stack([jnp.asarray(p[0]) for p in pairs])
    i2 = jnp.stack([jnp.asarray(p[1]) for p in pairs])
    cfg = LKConfig(iters=2, window=11)
    fb = lk_solve_batched(i1, i2, cfg)
    for k, p in enumerate(pairs):
        fs = lk_solve(jnp.asarray(p[0]), jnp.asarray(p[1]), cfg)
        assert float(jnp.abs(fb.u[k] - fs.u).max()) <= 2e-5
        assert float(jnp.abs(fb.v[k] - fs.v).max()) <= 2e-5


def test_flow_stream_lk_matches_batched():
    """Streaming LK (video.flow_stream(lk=...)) == one batched LK solve."""
    from hsflow.video import flow_stream

    rng = np.random.default_rng(19)
    frames = jnp.asarray(rng.uniform(0, 1, (5, 48, 64)).astype(np.float32))
    cfg = LKConfig(iters=2, window=9)
    chunks = list(flow_stream(frames, lk=cfg, chunk=2))
    u = jnp.concatenate([c.u for c in chunks])
    v = jnp.concatenate([c.v for c in chunks])
    ref = lk_solve_batched(frames[:-1], frames[1:], cfg)
    assert u.shape == ref.u.shape
    assert float(jnp.abs(u - ref.u).max()) <= 2e-5
    assert float(jnp.abs(v - ref.v).max()) <= 2e-5


def test_differentiable():
    i1, i2, _ = translation_pair(48, 64, 0.5, 0.0, key=11)

    def loss(a, b):
        f = lk_solve(a, b, LKConfig(iters=2, window=9))
        return jnp.mean(f.u * f.u + f.v * f.v)

    g = jax.grad(loss)(jnp.asarray(i1), jnp.asarray(i2))
    assert np.isfinite(np.asarray(g)).all()
    assert float(jnp.abs(g).max()) > 0


def test_shape_validation():
    a = jnp.zeros((32, 32))
    with pytest.raises(ValueError, match="differ"):
        lk_solve(a, jnp.zeros((32, 33)))
    with pytest.raises(ValueError, match="2-D"):
        lk_solve(jnp.zeros((2, 32, 32)), jnp.zeros((2, 32, 32)))
    with pytest.raises(ValueError, match="batch|B, H, W"):
        lk_solve_batched(a, a)
    with pytest.raises(ValueError, match="below 8"):
        lk_solve(a, a, pyr=PyramidConfig(levels=4))


def test_config_validation():
    with pytest.raises(ValueError):
        LKConfig(window=4)
    with pytest.raises(ValueError):
        LKConfig(window=1)
    with pytest.raises(ValueError):
        LKConfig(iters=0)
    with pytest.raises(ValueError):
        LKConfig(eps=0.0)
    with pytest.raises(ValueError):
        LKConfig(warp="nearest")


def test_runconfig_lk_section():
    from hsflow.config import load_config

    rc = load_config(overrides={"lk.window": "11", "lk.iters": "2",
                                "method": "lk"})
    assert rc.lk.window == 11 and rc.lk.iters == 2 and rc.method == "lk"
    with pytest.raises(ValueError, match="method"):
        load_config(overrides={"method": "farneback"})


def test_warp_radius_auto_matches_pinned():
    """The round-5 auto warp radius (PyramidConfig.warp_radius=0) must be
    value-identical to the old hard-coded R=4 behavior: the on-device cond
    picks the R=2 select loop only when the per-tile deviation proves both
    loops exact (pyramid.warp_bilinear_tiled). Smooth translation flows sit
    squarely in the auto regime, so this locks the fast path's values."""
    i1, i2, _ = translation_pair(64, 96, 0.7, -0.4, key=5)
    a, b = jnp.asarray(i1), jnp.asarray(i2)
    cfg = LKConfig(iters=2)
    f_auto = lk_solve(a, b, cfg, PyramidConfig(levels=2, warp_radius=0))
    f_r4 = lk_solve(a, b, cfg, PyramidConfig(levels=2, warp_radius=4))
    np.testing.assert_allclose(np.asarray(f_auto.u), np.asarray(f_r4.u), atol=1e-6)
    np.testing.assert_allclose(np.asarray(f_auto.v), np.asarray(f_r4.v), atol=1e-6)
