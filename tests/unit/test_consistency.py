"""Forward-backward consistency / occlusion masks (consistency.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

from hsflow.config import HSConfig
from hsflow.consistency import (
    fb_error,
    flow_with_occlusion,
    occlusion_mask,
    solve_bidirectional,
)
from hsflow.data.synthetic import translation_pair
from hsflow.solver import Flow, hs_solve


def test_consistent_pair_has_zero_error():
    h, w = 16, 24
    fwd = Flow(jnp.full((h, w), 2.0), jnp.zeros((h, w)))
    bwd = Flow(jnp.full((h, w), -2.0), jnp.zeros((h, w)))
    e = fb_error(fwd, bwd)
    assert float(jnp.abs(e).max()) < 1e-5
    assert not bool(occlusion_mask(fwd, bwd).any())


def test_inconsistent_pair_flags_everything():
    h, w = 16, 24
    fwd = Flow(jnp.full((h, w), 2.0), jnp.zeros((h, w)))
    bwd = Flow(jnp.zeros((h, w)), jnp.zeros((h, w)))  # backward says "static"
    e = fb_error(fwd, bwd)
    np.testing.assert_allclose(np.asarray(e), 2.0, atol=1e-5)
    assert bool(occlusion_mask(fwd, bwd).all())


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_solve_bidirectional_matches_separate_solves(backend, kernel_mode):
    i1, i2, _ = translation_pair(32, 64, 1.0, 0.5, key=4)
    i1, i2 = jnp.asarray(i1), jnp.asarray(i2)
    cfg = HSConfig(alpha=0.5, iters=40, backend=backend)
    fwd, bwd = solve_bidirectional(i1, i2, cfg)
    ff = hs_solve(i1, i2, cfg)
    fb = hs_solve(i2, i1, cfg)
    np.testing.assert_allclose(np.asarray(fwd.u), np.asarray(ff.u), atol=1e-6)
    np.testing.assert_allclose(np.asarray(bwd.u), np.asarray(fb.u), atol=1e-6)


def test_translation_pair_is_mostly_consistent():
    """An analytic (periodic-texture) translation has a near-inverse flow
    pair: interior occlusion fraction should be tiny."""
    i1, i2, _ = translation_pair(48, 64, 1.0, 0.0, key=7)
    flow, occ = flow_with_occlusion(
        jnp.asarray(i1), jnp.asarray(i2),
        HSConfig(alpha=0.1, iters=300, backend="jnp"),
    )
    interior_occ = np.asarray(occ)[8:-8, 8:-8]
    assert interior_occ.mean() < 0.05
    assert abs(float(jnp.mean(flow.u)) - 1.0) < 0.2


def test_flow_stream_occlusion_matches_per_pair():
    """Streaming masks == flow_with_occlusion per pair (same arithmetic),
    and the forward flow == plain flow_stream."""
    from hsflow.video import flow_stream, flow_stream_occlusion

    rng = np.random.default_rng(2)
    base = rng.uniform(0, 1, (24, 32)).astype(np.float32)
    video = np.stack([np.roll(base, k, axis=1) for k in range(5)])
    cfg = HSConfig(alpha=0.3, iters=30, backend="jnp")

    flows, masks = [], []
    for fl, m in flow_stream_occlusion(video, cfg, chunk=2):
        flows.append((np.asarray(fl.u), np.asarray(fl.v)))
        masks.append(np.asarray(m))
    ref_flows = [(np.asarray(f.u), np.asarray(f.v))
                 for f in flow_stream(video, cfg, chunk=2)]
    assert len(flows) == len(ref_flows)
    for (u, v), (ru, rv) in zip(flows, ref_flows):
        np.testing.assert_allclose(u, ru, atol=1e-6)
        np.testing.assert_allclose(v, rv, atol=1e-6)

    mask_all = np.concatenate(masks)
    assert mask_all.shape == (4, 24, 32)
    for k in range(4):
        _, occ = flow_with_occlusion(
            jnp.asarray(video[k]), jnp.asarray(video[k + 1]), cfg
        )
        np.testing.assert_array_equal(mask_all[k], np.asarray(occ))


def test_occluded_region_is_flagged():
    """Paste a block into frame 2 that exists nowhere in frame 1: pixels
    under the block have no true correspondence. The fb error must be
    orders of magnitude higher there than in the agreeing surround
    (measured ~0.1 px vs ~5e-10), and a threshold scaled to the scene's
    sub-pixel motion regime must flag the block interior. (The b=0.5
    default targets multi-pixel motion; it is scene-scale-dependent.)"""
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 1, (48, 64)).astype(np.float32)
    i1 = base
    i2 = base.copy()
    i2[16:32, 24:40] = rng.uniform(0, 1, (16, 16)).astype(np.float32)
    cfg = HSConfig(alpha=0.3, iters=200, backend="jnp")
    fwd, bwd = solve_bidirectional(jnp.asarray(i1), jnp.asarray(i2), cfg)
    e = np.asarray(fb_error(fwd, bwd))
    inside_err = e[18:30, 26:38].mean()   # block interior (eroded margin)
    outside_err = np.concatenate([e[:8].ravel(), e[-8:].ravel()]).mean()
    assert inside_err > 1e3 * max(outside_err, 1e-8)
    occ = np.asarray(occlusion_mask(fwd, bwd, a=0.01, b=0.02**2))
    inside = occ[18:30, 26:38].mean()
    outside = np.concatenate([occ[:8].ravel(), occ[-8:].ravel()]).mean()
    assert inside > 0.5
    assert outside < 0.05


def test_solve_bidirectional_lk_matches_separate_solves():
    """The consistency test is model-agnostic: the LK leg must equal two
    independent lk_solve calls (VERDICT r2 item 8)."""
    from hsflow.config import LKConfig
    from hsflow.lucas_kanade import lk_solve

    i1, i2, _ = translation_pair(48, 64, 1.0, 0.5, key=4)
    i1, i2 = jnp.asarray(i1), jnp.asarray(i2)
    cfg = LKConfig(window=9, iters=2)
    fwd, bwd = solve_bidirectional(i1, i2, lk=cfg)
    ff = lk_solve(i1, i2, cfg)
    fb = lk_solve(i2, i1, cfg)
    np.testing.assert_allclose(np.asarray(fwd.u), np.asarray(ff.u), atol=2e-5)
    np.testing.assert_allclose(np.asarray(bwd.u), np.asarray(fb.u), atol=2e-5)


def test_flow_with_occlusion_lk_translation_consistent():
    from hsflow.config import LKConfig

    i1, i2, _ = translation_pair(48, 64, 1.0, 0.0, key=7)
    flow, occ = flow_with_occlusion(
        jnp.asarray(i1), jnp.asarray(i2), lk=LKConfig(window=11, iters=3)
    )
    assert np.asarray(occ)[8:-8, 8:-8].mean() < 0.05
    assert abs(float(jnp.mean(flow.u)) - 1.0) < 0.2


def test_mutually_exclusive_families():
    from hsflow.config import LKConfig, TVL1Config

    a = jnp.zeros((16, 16))
    with pytest.raises(ValueError, match="at most one"):
        solve_bidirectional(a, a, lk=LKConfig(), tvl1=TVL1Config())
