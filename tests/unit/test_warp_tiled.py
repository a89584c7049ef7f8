"""Tiled fast warp (pyramid.warp_bilinear_tiled) vs the reference gather warp."""

import jax.numpy as jnp
import numpy as np
import pytest

from hsflow.pyramid import warp, warp_bilinear, warp_bilinear_tiled


def _img(h, w, seed=0):
    return jnp.asarray(
        np.random.default_rng(seed).uniform(0, 1, (h, w)).astype(np.float32)
    )


def _smooth_flow(h, w, amp_u=8.0, amp_v=6.0):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    u = amp_u * np.sin(yy / h * 3.1) * np.cos(xx / w * 2.0)
    v = amp_v * np.cos(yy / h * 2.2) * np.sin(xx / w * 2.7)
    return jnp.asarray(u), jnp.asarray(v)


@pytest.mark.parametrize("h,w", [(200, 300), (256, 384), (544, 960)])
def test_tiled_matches_gather_smooth(h, w):
    img = _img(h, w)
    u, v = _smooth_flow(h, w)
    a = warp_bilinear(img, u, v)
    b = warp_bilinear_tiled(img, u, v)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("du,dv", [(0.0, 0.0), (37.3, -21.9), (-3.25, 5.5)])
def test_tiled_matches_gather_constant(du, dv):
    img = _img(96, 160, seed=2)
    u = jnp.full((96, 160), du)
    v = jnp.full((96, 160), dv)
    a = warp_bilinear(img, u, v)
    b = warp_bilinear_tiled(img, u, v)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_tiled_identity_exact():
    img = _img(67, 93, seed=3)
    z = jnp.zeros((67, 93))
    np.testing.assert_array_equal(
        np.asarray(warp_bilinear_tiled(img, z, z)), np.asarray(img)
    )


def test_warp_dispatch():
    img = _img(64, 128, seed=4)
    u, v = _smooth_flow(64, 128, 2.0, 1.5)
    g = warp(img, u, v, "gather")
    t = warp(img, u, v, "tiled")
    a = warp(img, u, v, "auto")
    np.testing.assert_allclose(np.asarray(g), np.asarray(t), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(t))


def test_tiled_degrades_gracefully_on_wild_flow():
    """Per-tile deviation beyond R clamps sampling positions — output stays
    finite and within the image's value range (no NaN/garbage)."""
    img = _img(128, 256, seed=5)
    rng = np.random.default_rng(6)
    u = jnp.asarray(rng.uniform(-40, 40, (128, 256)).astype(np.float32))
    v = jnp.asarray(rng.uniform(-40, 40, (128, 256)).astype(np.float32))
    b = np.asarray(warp_bilinear_tiled(img, u, v))
    assert np.isfinite(b).all()
    assert b.min() >= float(img.min()) - 1e-5
    assert b.max() <= float(img.max()) + 1e-5
