"""Pyramid + warp integration (SURVEY.md §4: pyramid beats single-level on
large displacements; warp with GT flow reconstructs frame 1)."""

import jax.numpy as jnp
import numpy as np
import pytest

from hsflow.config import HSConfig, PyramidConfig
from hsflow.data.synthetic import WarpSpec, synthetic_pair, translation_pair
from hsflow.metrics import epe, interior
from hsflow.pyramid import (
    downsample2x,
    gaussian_pyramid,
    hs_pyramid,
    upsample_flow,
    warp_bilinear,
)
from hsflow.solver import Flow, hs_solve


def _flow_np(flow):
    return np.stack([np.asarray(flow.u), np.asarray(flow.v)], axis=-1)


@pytest.fixture(scope="module")
def large_displacement_pair():
    # 4 px translation: far outside single-level HS's linearization range,
    # easily recovered coarse-to-fine. Low frequency so coarse levels alias-free.
    return synthetic_pair(96, 128, WarpSpec.translation(4.0, 0.0), key=13, max_freq=0.06)


class TestWarp:
    def test_gt_flow_reconstructs_frame1(self):
        # Low-frequency texture: bilinear interpolation error scales ~(pi*f)^2,
        # so at 0.04 cycles/px the subpixel warp must reconstruct I1 closely.
        i1, i2, gt = synthetic_pair(
            48, 64, WarpSpec.translation(1.5, -0.5), key=2, max_freq=0.04
        )
        i2w = warp_bilinear(jnp.asarray(i2), jnp.asarray(gt[..., 0]), jnp.asarray(gt[..., 1]))
        err = np.abs(interior(np.asarray(i2w), 4) - interior(i1, 4))
        assert err.max() < 0.02, f"max warp error {err.max()}"

    def test_zero_flow_is_identity(self):
        rng = np.random.default_rng(0)
        img = jnp.asarray(rng.uniform(size=(16, 24)).astype(np.float32))
        z = jnp.zeros((16, 24), jnp.float32)
        np.testing.assert_allclose(np.asarray(warp_bilinear(img, z, z)), np.asarray(img), atol=1e-6)

    def test_integer_flow_is_exact_shift(self):
        rng = np.random.default_rng(1)
        img = jnp.asarray(rng.uniform(size=(16, 24)).astype(np.float32))
        u = jnp.full((16, 24), 2.0)
        v = jnp.zeros((16, 24))
        out = np.asarray(warp_bilinear(img, u, v))
        np.testing.assert_allclose(out[:, :-2], np.asarray(img)[:, 2:], atol=1e-6)


class TestPyramidOps:
    def test_downsample_shape(self):
        img = jnp.zeros((33, 47))
        assert downsample2x(img).shape == (17, 24)

    def test_downsample_preserves_constant(self):
        img = jnp.full((32, 32), 0.6)
        np.testing.assert_allclose(np.asarray(downsample2x(img)), 0.6, atol=1e-6)

    def test_pyramid_levels(self):
        pyr = gaussian_pyramid(jnp.zeros((64, 96)), 3)
        assert [p.shape for p in pyr] == [(64, 96), (32, 48), (16, 24)]

    def test_upsample_flow_doubles_values(self):
        flow = Flow(jnp.full((8, 8), 1.0), jnp.full((8, 8), -2.0))
        up = upsample_flow(flow, (16, 16))
        np.testing.assert_allclose(np.asarray(up.u), 2.0, atol=1e-5)
        np.testing.assert_allclose(np.asarray(up.v), -4.0, atol=1e-5)
        assert up.u.shape == (16, 16)


class TestCoarseToFine:
    def test_pyramid_beats_single_level(self, large_displacement_pair):
        i1, i2, gt = large_displacement_pair
        cfg = HSConfig(alpha=0.5, iters=300, backend="jnp")
        single = hs_solve(jnp.asarray(i1), jnp.asarray(i2), cfg)
        pyr = hs_pyramid(jnp.asarray(i1), jnp.asarray(i2), cfg, PyramidConfig(levels=3))
        e_single = epe(interior(_flow_np(single), 10), interior(gt, 10))
        e_pyr = epe(interior(_flow_np(pyr), 10), interior(gt, 10))
        assert e_pyr < e_single * 0.5, f"pyramid {e_pyr} vs single {e_single}"
        assert e_pyr < 0.6, f"pyramid EPE {e_pyr}"

    def test_one_level_equals_hs_solve(self, small_translation_pair):
        i1, i2, _ = small_translation_pair
        cfg = HSConfig(alpha=0.5, iters=50, backend="jnp")
        a = hs_solve(jnp.asarray(i1), jnp.asarray(i2), cfg)
        b = hs_pyramid(jnp.asarray(i1), jnp.asarray(i2), cfg, PyramidConfig(levels=1))
        np.testing.assert_allclose(np.asarray(a.u), np.asarray(b.u), atol=1e-6)
        np.testing.assert_allclose(np.asarray(a.v), np.asarray(b.v), atol=1e-6)

    def test_too_many_levels_rejected(self):
        with pytest.raises(ValueError):
            hs_pyramid(jnp.zeros((16, 16)), jnp.zeros((16, 16)), pyr=PyramidConfig(levels=3))

    def test_iters_per_level(self, small_translation_pair):
        i1, i2, _ = small_translation_pair
        cfg = HSConfig(alpha=0.5, iters=10, backend="jnp")
        hs_pyramid(
            jnp.asarray(i1), jnp.asarray(i2), cfg,
            PyramidConfig(levels=2, iters_per_level=(20, 40)),
        )


def test_warp_bilinear_batched_matches_vmap():
    """Batched (B, H, W) warp with per-batch flows must equal a vmap of the
    2-D warp (regression: the batched gather used wrong indexing)."""
    import jax
    import jax.numpy as jnp
    from hsflow.pyramid import warp_bilinear

    rng = np.random.default_rng(11)
    img = jnp.asarray(rng.uniform(0, 1, (3, 17, 23)).astype(np.float32))
    u = jnp.asarray(rng.uniform(-2, 2, (3, 17, 23)).astype(np.float32))
    v = jnp.asarray(rng.uniform(-2, 2, (3, 17, 23)).astype(np.float32))
    got = warp_bilinear(img, u, v)
    want = jax.vmap(warp_bilinear)(img, u, v)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-6)


def test_warp_radius_dial():
    """Round-5 VERDICT item 4: PyramidConfig.warp_radius. radius=0 (auto)
    must equal R=4 bitwise on BOTH sides of the on-device cond — the cheap
    R=2 branch only fires when it is exact — while a forced-small radius on
    a rough flow shows the clamp (documenting why auto is the default)."""
    import numpy as np

    from hsflow.pyramid import warp_bilinear, warp_bilinear_tiled

    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.uniform(0, 1, (200, 300)).astype(np.float32))

    def flow(scale):
        u = scale * np.sin(np.linspace(0, 3, 300))[None, :] * np.ones((200, 1))
        v = scale * np.cos(np.linspace(0, 2, 200))[:, None] * np.ones((1, 300))
        return jnp.asarray(u.astype(np.float32)), jnp.asarray(v.astype(np.float32))

    for scale in (1.0, 6.0):  # dev <= 2 branch, then the R=4 branch
        u, v = flow(scale)
        w4 = warp_bilinear_tiled(img, u, v, 4)
        wa = warp_bilinear_tiled(img, u, v, 0)
        assert float(jnp.abs(wa - w4).max()) == 0.0, scale
        # exactness vs the reference gather (bilinear association slack)
        assert float(jnp.abs(wa - warp_bilinear(img, u, v)).max()) <= 3e-7

    # forced R=2 on the rough flow clamps (inexact) — the auto cond exists
    # exactly to avoid this while still taking the 25-combo loop when safe
    u, v = flow(6.0)
    w2 = warp_bilinear_tiled(img, u, v, 2)
    assert float(jnp.abs(w2 - warp_bilinear(img, u, v)).max()) > 0.01


def test_pyramid_warp_radius_config():
    """The pyramid accepts and routes warp_radius; flows match between auto
    and fixed-4 on an HS-smooth problem."""
    i1, i2, _ = translation_pair(96, 128, 2.0, -1.0, key=2)
    i1, i2 = jnp.asarray(i1), jnp.asarray(i2)
    cfg = HSConfig(alpha=0.25, iters=40)
    fa = hs_pyramid(i1, i2, cfg, PyramidConfig(levels=2, iters_per_level=(),
                                               warp_radius=0))
    f4 = hs_pyramid(i1, i2, cfg, PyramidConfig(levels=2, iters_per_level=(),
                                               warp_radius=4))
    assert float(jnp.abs(fa.u - f4.u).max()) <= 1e-6
    assert float(jnp.abs(fa.v - f4.v).max()) <= 1e-6
