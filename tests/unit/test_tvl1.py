"""TV-L1 flow (tvl1.py) — the third model family (Zach/Pock/Bischof 2007).

Oracle chain per SURVEY.md §4, mirroring the LK precedent
(test_lucas_kanade.py): analytic-GT synthetic pairs are the foundation;
plus exact adjoint/median operator oracles and batched == loop-of-singles.
The grad/div adjoint identity and the Chambolle sign convention are the two
spots where an internally-inconsistent implementation still "runs" while
diverging (the round-2 advisor caught exactly that), so both are pinned
here numerically.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hsflow import (
    HSConfig,
    PyramidConfig,
    TVL1Config,
    hs_solve,
    tvl1_solve,
    tvl1_solve_batched,
)
from hsflow.data.synthetic import translation_pair, two_motion_pair
from hsflow.metrics import epe, interior
from hsflow.tvl1 import (
    _mask_dual,
    divergence,
    grad_forward,
    median3,
    tvl1_warp_iteration,
)


def _epe(f, gt, crop=12):
    fl = np.stack([np.asarray(f.u), np.asarray(f.v)], -1)
    return float(epe(interior(fl, crop), interior(gt, crop)))


# -- operator oracles ---------------------------------------------------------


def test_grad_div_adjoint_identity():
    """<grad u, p> == -<u, div p> exactly, for masked duals — the discrete
    adjoint pair Chambolle's dual ascent requires. Float64 so the identity
    is tested to near machine precision."""
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal((13, 17)).astype(np.float32))
    px = jnp.asarray(rng.standard_normal((13, 17)).astype(np.float32))
    py = jnp.asarray(rng.standard_normal((13, 17)).astype(np.float32))
    px, py = _mask_dual(px, py)
    gx, gy = grad_forward(u)
    # Accumulate the inner products in float64 ON THE HOST so the identity
    # is tested to near machine precision (the jnp ops themselves are exact
    # rearrangements; only the reduction needs widening).
    lhs = float(np.sum(np.asarray(gx, np.float64) * np.asarray(px, np.float64)
                       + np.asarray(gy, np.float64) * np.asarray(py, np.float64)))
    rhs = float(-np.sum(np.asarray(u, np.float64)
                        * np.asarray(divergence(px, py), np.float64)))
    # divergence is computed in fp32, so allow fp32-roundoff on its side
    assert abs(lhs - rhs) < 1e-4


def test_grad_forward_matches_numpy():
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 1, (9, 11)).astype(np.float32)
    gx, gy = grad_forward(jnp.asarray(a))
    ref_gx = np.zeros_like(a)
    ref_gx[:, :-1] = a[:, 1:] - a[:, :-1]  # forward diff, 0 at last column
    ref_gy = np.zeros_like(a)
    ref_gy[:-1, :] = a[1:, :] - a[:-1, :]
    np.testing.assert_allclose(np.asarray(gx), ref_gx, atol=1e-6)
    np.testing.assert_allclose(np.asarray(gy), ref_gy, atol=1e-6)


def test_median3_matches_numpy():
    rng = np.random.default_rng(2)
    a = rng.uniform(0, 1, (14, 19)).astype(np.float32)
    out = np.asarray(median3(jnp.asarray(a)))
    pad = np.pad(a, 1, mode="edge")
    ref = np.empty_like(a)
    for i in range(a.shape[0]):
        for j in range(a.shape[1]):
            ref[i, j] = np.median(pad[i : i + 3, j : j + 3])
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_warp_iteration_fixed_point_is_stable():
    """On identical frames, zero flow must stay (near) zero through a full
    warp iteration — a sign error in the u-step/dual-update pairing breaks
    this immediately (the dual ascent injects energy instead of removing
    it)."""
    rng = np.random.default_rng(3)
    img = jnp.asarray(rng.uniform(0, 1, (32, 48)).astype(np.float32))
    z = jnp.zeros_like(img)
    u1, u2 = tvl1_warp_iteration(img, img, z, z, TVL1Config(median=False))
    assert float(jnp.abs(u1).max()) < 1e-3
    assert float(jnp.abs(u2).max()) < 1e-3


# -- synthetic-GT accuracy ----------------------------------------------------


@pytest.mark.parametrize("du,dv", [(1.0, 0.0), (0.0, 1.0), (0.7, -0.4)])
def test_recovers_small_translation(du, dv):
    i1, i2, gt = translation_pair(96, 128, du, dv, key=3)
    flow = tvl1_solve(jnp.asarray(i1), jnp.asarray(i2), TVL1Config())
    assert _epe(flow, gt) < 0.08


def test_recovers_negative_translation_via_pyramid():
    """The advisor's round-2 repro: -3 px translation, 3 levels. The broken
    sign diverged to u=+24.5; the fixed solver must land on -3."""
    i1, i2, gt = translation_pair(96, 128, -3.0, 0.0, key=3)
    flow = tvl1_solve(
        jnp.asarray(i1), jnp.asarray(i2), TVL1Config(), PyramidConfig(levels=3)
    )
    assert abs(float(jnp.mean(flow.u)) + 3.0) < 0.15
    assert _epe(flow, gt) < 0.08


def test_pyramid_handles_large_displacement():
    i1, i2, gt = translation_pair(128, 192, 5.0, 0.0, key=7)
    i1, i2 = jnp.asarray(i1), jnp.asarray(i2)
    single = tvl1_solve(i1, i2, TVL1Config())
    pyr = tvl1_solve(i1, i2, TVL1Config(), PyramidConfig(levels=3))
    e1, e3 = _epe(single, gt, 16), _epe(pyr, gt, 16)
    assert e3 < 0.25
    assert e3 < e1 / 4


def test_sharper_seam_than_hs():
    """The model-family contract: on a two-motion seam, the TV prior keeps
    the boundary piecewise-constant where quadratic HS smears it — the
    seam-region EPE must beat HS at its parity defaults."""
    i1, i2, gt = two_motion_pair(96, 128, (1.0, 0.0), (-1.0, 0.0), key=3)
    i1, i2 = jnp.asarray(i1), jnp.asarray(i2)
    f_tv = tvl1_solve(i1, i2, TVL1Config())
    f_hs = hs_solve(i1, i2, HSConfig(alpha=0.5, iters=300))
    # Evaluate on the seam band (center third of the columns), interior rows.
    w = gt.shape[1]
    band = slice(w // 3, 2 * w // 3)

    def band_epe(f):
        fl = np.stack([np.asarray(f.u), np.asarray(f.v)], -1)
        return float(epe(fl[12:-12, band], gt[12:-12, band]))

    assert band_epe(f_tv) < band_epe(f_hs)
    assert band_epe(f_tv) < 0.1  # measured 0.062 vs HS 0.25


def test_median_toggle_changes_result_and_helps_outliers():
    """median=True must actually run (different flow), and on a frame pair
    with salt-noise outliers it must not be worse than median=False."""
    i1, i2, gt = translation_pair(64, 96, 1.0, 0.0, key=5)
    rng = np.random.default_rng(9)
    hits = rng.uniform(size=i2.shape) < 0.003
    i2n = np.where(hits, 1.0, i2).astype(np.float32)
    i1, i2n = jnp.asarray(i1), jnp.asarray(i2n)
    f_med = tvl1_solve(i1, i2n, TVL1Config(median=True))
    f_raw = tvl1_solve(i1, i2n, TVL1Config(median=False))
    assert float(jnp.abs(f_med.u - f_raw.u).max()) > 1e-6
    assert _epe(f_med, gt) <= _epe(f_raw, gt) + 1e-4


# -- batching / streaming -----------------------------------------------------


def test_batched_matches_singles():
    pairs = [translation_pair(64, 96, d, 0.3, key=k) for k, d in
             enumerate((0.5, 1.0, -0.8))]
    i1 = jnp.stack([jnp.asarray(p[0]) for p in pairs])
    i2 = jnp.stack([jnp.asarray(p[1]) for p in pairs])
    cfg = TVL1Config(warps=2, iters=20)
    fb = tvl1_solve_batched(i1, i2, cfg)
    for k, p in enumerate(pairs):
        fs = tvl1_solve(jnp.asarray(p[0]), jnp.asarray(p[1]), cfg)
        assert float(jnp.abs(fb.u[k] - fs.u).max()) <= 2e-5
        assert float(jnp.abs(fb.v[k] - fs.v).max()) <= 2e-5


def test_flow_stream_tvl1_matches_batched():
    from hsflow.video import flow_stream

    rng = np.random.default_rng(19)
    frames = jnp.asarray(rng.uniform(0, 1, (5, 48, 64)).astype(np.float32))
    cfg = TVL1Config(warps=2, iters=15)
    chunks = list(flow_stream(frames, tvl1=cfg, chunk=2))
    u = jnp.concatenate([c.u for c in chunks])
    ref = tvl1_solve_batched(frames[:-1], frames[1:], cfg)
    assert u.shape == ref.u.shape
    assert float(jnp.abs(u - ref.u).max()) <= 2e-5


def test_occlusion_stream_tvl1():
    """flow_stream_occlusion(tvl1=...) yields masks consistent with a
    direct bidirectional batched solve."""
    from hsflow.consistency import occlusion_mask
    from hsflow.solver import Flow
    from hsflow.video import flow_stream_occlusion

    rng = np.random.default_rng(23)
    frames = jnp.asarray(rng.uniform(0, 1, (3, 48, 64)).astype(np.float32))
    cfg = TVL1Config(warps=1, iters=10)
    out = list(flow_stream_occlusion(frames, tvl1=cfg, chunk=2))
    assert sum(f.u.shape[0] for f, _ in out) == 2
    fb = tvl1_solve_batched(
        jnp.concatenate([frames[:-1], frames[1:]]),
        jnp.concatenate([frames[1:], frames[:-1]]),
        cfg,
    )
    fwd = Flow(fb.u[:2], fb.v[:2])
    bwd = Flow(fb.u[2:], fb.v[2:])
    ref = jax.vmap(occlusion_mask)(fwd, bwd)
    got = jnp.concatenate([jnp.asarray(m) for _, m in out])
    assert bool(jnp.array_equal(got, ref))


# -- autodiff -----------------------------------------------------------------


def test_differentiable():
    i1, i2, _ = translation_pair(48, 64, 0.5, 0.0, key=11)

    def loss(a, b):
        f = tvl1_solve(a, b, TVL1Config(warps=1, iters=5, median=False))
        return jnp.mean(f.u * f.u + f.v * f.v)

    g = jax.grad(loss)(jnp.asarray(i1), jnp.asarray(i2))
    assert np.isfinite(np.asarray(g)).all()
    assert float(jnp.abs(g).max()) > 0


# -- validation / config ------------------------------------------------------


def test_shape_validation():
    a = jnp.zeros((32, 32))
    with pytest.raises(ValueError, match="differ"):
        tvl1_solve(a, jnp.zeros((32, 33)))
    with pytest.raises(ValueError, match="2-D"):
        tvl1_solve(jnp.zeros((2, 32, 32)), jnp.zeros((2, 32, 32)))
    with pytest.raises(ValueError, match="B, H, W"):
        tvl1_solve_batched(a, a)
    with pytest.raises(ValueError, match="below 8"):
        tvl1_solve(a, a, pyr=PyramidConfig(levels=4))
    with pytest.raises(ValueError, match="warps_per_level"):
        tvl1_solve(a, a, TVL1Config(warps_per_level=(2, 1)),
                   PyramidConfig(levels=1))


def test_config_validation():
    with pytest.raises(ValueError):
        TVL1Config(lambda_=0.0)
    with pytest.raises(ValueError):
        TVL1Config(theta=-1.0)
    with pytest.raises(ValueError):
        TVL1Config(tau=0.3)  # Chambolle stability bound
    with pytest.raises(ValueError):
        TVL1Config(warps=0)
    with pytest.raises(ValueError):
        TVL1Config(iters=0)
    with pytest.raises(ValueError):
        TVL1Config(warps_per_level=(2, 0))
    with pytest.raises(ValueError):
        TVL1Config(warp="nearest")


def test_warps_per_level_overrides_and_ignores_hs_iters():
    """pyr.iters_per_level counts HS Jacobi sweeps and must NOT silently
    become warp counts; TVL1Config.warps_per_level is the override."""
    i1, i2, _ = translation_pair(48, 64, 0.5, 0.0, key=13)
    i1, i2 = jnp.asarray(i1), jnp.asarray(i2)
    pyr_hs_tuned = PyramidConfig(levels=2, iters_per_level=(100, 50))
    base = TVL1Config(warps=2, iters=10)
    # HS-tuned per-level sweep counts are ignored: identical result.
    f_a = tvl1_solve(i1, i2, base, PyramidConfig(levels=2))
    f_b = tvl1_solve(i1, i2, base, pyr_hs_tuned)
    assert float(jnp.abs(f_a.u - f_b.u).max()) == 0.0
    # warps_per_level IS honored: (2, 2) == warps=2, (1, 1) differs.
    f_c = tvl1_solve(i1, i2, dataclasses.replace(base, warps_per_level=(2, 2)),
                     PyramidConfig(levels=2))
    assert float(jnp.abs(f_a.u - f_c.u).max()) == 0.0
    f_d = tvl1_solve(i1, i2, dataclasses.replace(base, warps_per_level=(1, 1)),
                     PyramidConfig(levels=2))
    assert float(jnp.abs(f_a.u - f_d.u).max()) > 0.0


def test_runconfig_tvl1_section():
    from hsflow.config import load_config

    rc = load_config(overrides={"tvl1.lambda_": "0.2", "tvl1.iters": "40",
                                "tvl1.warps_per_level": "3,2,1",
                                "method": "tvl1"})
    assert rc.tvl1.lambda_ == 0.2 and rc.tvl1.iters == 40
    assert rc.tvl1.warps_per_level == (3, 2, 1)
    assert rc.method == "tvl1"


def test_cli_dispatches_tvl1(tmp_path):
    """End-to-end CLI: --method tvl1 must run the TV-L1 solver (NOT fall
    through to HS — the round-2 silent-wrong-method bug) and write a .flo
    that matches a direct tvl1_solve call."""
    from hsflow.cli import main
    from hsflow.io.flo import read_flo
    from hsflow.io.images import save_image

    i1, i2, _ = translation_pair(48, 64, 1.0, 0.0, key=17)
    p1, p2 = str(tmp_path / "a.pgm"), str(tmp_path / "b.pgm")
    save_image(p1, i1)
    save_image(p2, i2)
    out = str(tmp_path / "out.flo")
    rc = main(["run", p1, p2, "-o", out, "--method", "tvl1",
               "--tvl1.warps", "2", "--tvl1.iters", "10",
               "--pyramid.levels", "1"])
    assert rc == 0
    got = read_flo(out)
    from hsflow.io.images import load_gray

    ref = tvl1_solve(jnp.asarray(load_gray(p1)), jnp.asarray(load_gray(p2)),
                     TVL1Config(warps=2, iters=10))
    np.testing.assert_allclose(
        got, np.stack([np.asarray(ref.u), np.asarray(ref.v)], -1), atol=1e-6
    )


def test_cli_config_file_method_routes_to_tvl1(tmp_path):
    """method="tvl1" coming from a config FILE (not --method) must reach the
    TV-L1 branch — the round-2 bug fell through to HS while printing a
    tvl1 label. Proven by matching the direct tvl1_solve output."""
    import json as _json

    from hsflow.cli import main
    from hsflow.io.flo import read_flo
    from hsflow.io.images import load_gray, save_image

    i1, i2, _ = translation_pair(48, 64, 1.0, 0.0, key=17)
    p1, p2 = str(tmp_path / "a.pgm"), str(tmp_path / "b.pgm")
    save_image(p1, i1)
    save_image(p2, i2)
    cfgp = str(tmp_path / "cfg.json")
    with open(cfgp, "w") as f:
        _json.dump({"method": "tvl1", "tvl1": {"warps": 2, "iters": 10},
                    "pyramid": {"levels": 1}}, f)
    out = str(tmp_path / "out.flo")
    assert main(["--config", cfgp, "run", p1, p2, "-o", out]) == 0
    got = read_flo(out)
    ref = tvl1_solve(jnp.asarray(load_gray(p1)), jnp.asarray(load_gray(p2)),
                     TVL1Config(warps=2, iters=10))
    np.testing.assert_allclose(
        got, np.stack([np.asarray(ref.u), np.asarray(ref.v)], -1), atol=1e-6
    )


def test_median3_network_equals_sort():
    """median3's 19-exchange selection network must equal the 9-stack sort
    formulation EXACTLY (order statistics are method-independent),
    including ties — the network is ~4x cheaper (round 5)."""
    import numpy as np

    from hsflow import tvl1
    from hsflow.ops import stencils

    def median3_sort(a):
        up, dn = stencils.shift_up_row(a), stencils.shift_down_row(a)
        taps = []
        for r in (dn, a, up):
            taps.extend(
                (stencils.shift_right_col(r), r, stencils.shift_left_col(r))
            )
        return jnp.sort(jnp.stack(taps, axis=0), axis=0)[4]

    rng = np.random.default_rng(0)
    for arr in (
        rng.normal(0, 1, (67, 93)).astype(np.float32),
        rng.integers(0, 3, (64, 64)).astype(np.float32),  # heavy ties
    ):
        a = jnp.asarray(arr)
        assert float(jnp.abs(tvl1.median3(a) - median3_sort(a)).max()) == 0.0
