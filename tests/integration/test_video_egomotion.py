"""Streaming video flow (N8) and ego-motion estimation (N9) tests."""

import jax.numpy as jnp
import numpy as np
import pytest

from hsflow.batch import hs_solve_batched
from hsflow.config import HSConfig, MeshConfig
from hsflow.data.synthetic import translation_pair
from hsflow.egomotion import estimate_egomotion
from hsflow.solver import Flow
from hsflow.video import flow_stream, flow_video

CFG = HSConfig(alpha=0.3, iters=60, backend="jnp")


def _video(t=10, h=32, w=48):
    """Deterministic smooth texture translating 1 px/frame in x."""
    rng = np.random.default_rng(2)
    base = rng.uniform(0, 1, (h, w + t + 4)).astype(np.float32)
    # separable box blur to make it trackable
    for _ in range(3):
        base = 0.25 * (np.roll(base, 1, 0) + np.roll(base, -1, 0) + base * 2)
        base = 0.25 * (np.roll(base, 1, 1) + np.roll(base, -1, 1) + base * 2)
    return np.stack([base[:, k : k + w] for k in range(t)])


def test_flow_video_matches_batched():
    vid = _video()
    fv = flow_video(vid, CFG, chunk=4)
    fb = hs_solve_batched(jnp.asarray(vid[:-1]), jnp.asarray(vid[1:]), CFG)
    assert fv.u.shape == (vid.shape[0] - 1, *vid.shape[1:])
    np.testing.assert_allclose(np.asarray(fv.u), np.asarray(fb.u), atol=1e-6)
    np.testing.assert_allclose(np.asarray(fv.v), np.asarray(fb.v), atol=1e-6)


def test_flow_stream_mesh_dp_matches_unsharded():
    """DP streaming: chunks sharded over the mesh 'batch' axis == the
    unsharded stream, including a remainder chunk that does not divide
    the mesh batch (which silently runs unsharded)."""
    from hsflow.dist import make_mesh
    from hsflow.video import flow_stream_occlusion

    vid = _video(t=8)  # 7 pairs -> chunks of 4 + remainder 3
    mesh = make_mesh(MeshConfig(batch=2, y=1, x=1))
    fm = [f for f in flow_stream(vid, CFG, chunk=4, mesh=mesh)]
    fu = [f for f in flow_stream(vid, CFG, chunk=4)]
    assert len(fm) == len(fu) == 2
    for a, b in zip(fm, fu):
        np.testing.assert_allclose(np.asarray(a.u), np.asarray(b.u),
                                   atol=1e-6)
    # occlusion stream with mesh runs too
    got = [m for _, m in flow_stream_occlusion(vid, CFG, chunk=4, mesh=mesh)]
    assert sum(m.shape[0] for m in got) == 7


def test_flow_stream_iterator_input():
    vid = _video(t=7)
    chunks = list(flow_stream(iter(list(vid)), CFG, chunk=3))
    total_pairs = sum(int(c.u.shape[0]) for c in chunks)
    assert total_pairs == 6
    # scene content shifts left 1 px/frame; partially-converged HS at 60
    # iters recovers the sign and a sizable fraction of the magnitude
    u_mean = float(np.mean([np.asarray(c.u[:, 8:-8, 8:-8]).mean() for c in chunks]))
    assert -1.3 < u_mean < -0.25


def test_flow_stream_rejects_bad_args():
    with pytest.raises(ValueError, match="chunk"):
        list(flow_stream(_video(), chunk=0))
    with pytest.raises(ValueError, match="T, H, W"):
        list(flow_stream(np.zeros((8, 8)), CFG))


# -- ego-motion ---------------------------------------------------------------


def _model_flow(h, w, tx, ty, omega, s):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cx, cy = (w - 1) / 2, (h - 1) / 2
    xb, yb = xx - cx, yy - cy
    u = tx + s * xb - omega * yb
    v = ty + s * yb + omega * xb
    return Flow(jnp.asarray(u), jnp.asarray(v))


@pytest.mark.parametrize(
    "tx,ty,omega,s",
    [(1.5, -0.5, 0.0, 0.0), (0.0, 0.0, 0.02, 0.0), (0.3, 0.1, -0.01, 0.005)],
)
def test_egomotion_recovers_exact_model(tx, ty, omega, s):
    em = estimate_egomotion(_model_flow(48, 64, tx, ty, omega, s))
    assert abs(float(em.tx) - tx) < 1e-4
    assert abs(float(em.ty) - ty) < 1e-4
    assert abs(float(em.omega) - omega) < 1e-5
    assert abs(float(em.scale) - s) < 1e-5
    assert float(em.residual) < 1e-4


def test_egomotion_foe():
    # pure zoom from a known center: FOE should be that center (relative)
    em = estimate_egomotion(_model_flow(64, 64, 0.0, 0.0, 0.0, 0.05))
    fx, fy = em.focus_of_expansion()
    assert abs(float(fx)) < 1e-3 and abs(float(fy)) < 1e-3


def test_egomotion_batched():
    f1 = _model_flow(32, 32, 1.0, 0.0, 0.0, 0.0)
    f2 = _model_flow(32, 32, 0.0, 2.0, 0.0, 0.0)
    f = Flow(jnp.stack([f1.u, f2.u]), jnp.stack([f1.v, f2.v]))
    em = estimate_egomotion(f)
    np.testing.assert_allclose(np.asarray(em.tx), [1.0, 0.0], atol=1e-4)
    np.testing.assert_allclose(np.asarray(em.ty), [0.0, 2.0], atol=1e-4)


def test_egomotion_from_real_flow():
    """End-to-end: HS flow of a translating pair -> ego translation."""
    i1, i2, _ = translation_pair(48, 64, 1.0, 0.0, key=4)
    from hsflow.solver import hs_solve

    f = hs_solve(jnp.asarray(i1), jnp.asarray(i2), HSConfig(alpha=0.1, iters=800))
    em = estimate_egomotion(f)
    assert abs(float(em.tx) - 1.0) < 0.25
    assert abs(float(em.ty)) < 0.15


def test_egomotion_sharded_matches_unsharded():
    """psum-moment path inside shard_map == single-device estimate."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from hsflow.dist import make_mesh

    flow = _model_flow(32, 64, 0.7, -0.2, 0.01, 0.003)
    mesh = make_mesh(MeshConfig(batch=1, y=2, x=4))
    th, tw = 16, 16

    def body(u, v):
        iy = jax.lax.axis_index("y")
        ix = jax.lax.axis_index("x")
        em = estimate_egomotion(
            Flow(u, v),
            axis_names=("y", "x"),
            global_offset=(iy * th, ix * tw),
        )
        return jnp.stack([em.tx, em.ty, em.omega, em.scale, em.residual])

    fn = jax.jit(
        jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(P("y", "x"), P("y", "x")),
            out_specs=P(),
        )
    )
    sh = NamedSharding(mesh, P("y", "x"))
    got = np.asarray(fn(jax.device_put(flow.u, sh), jax.device_put(flow.v, sh)))
    ref = estimate_egomotion(flow)
    np.testing.assert_allclose(
        got, [float(ref.tx), float(ref.ty), float(ref.omega), float(ref.scale), float(ref.residual)],
        atol=1e-4,
    )


def test_egomotion_explicit_offcenter_is_exact_ls():
    """An explicit `center` away from the coordinate centroid must still
    yield the exact least-squares fit (the fit runs centroid-centered and
    (tx, ty) are reparametrized to the requested center afterwards)."""
    import numpy as np
    import jax.numpy as jnp
    from hsflow.solver import Flow
    from hsflow.egomotion import estimate_egomotion

    h, w = 40, 60
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cx, cy, tx, ty, s, om = 10.0, 5.0, 1.5, -0.5, 0.02, 0.01
    u = tx + s * (xx - cx) - om * (yy - cy)
    v = ty + s * (yy - cy) + om * (xx - cx)
    e = estimate_egomotion(Flow(jnp.asarray(u), jnp.asarray(v)), center=(cx, cy))
    assert abs(float(e.tx) - tx) < 1e-4 and abs(float(e.ty) - ty) < 1e-4
    assert abs(float(e.scale) - s) < 1e-6 and abs(float(e.omega) - om) < 1e-6
    assert float(e.residual) < 1e-4


def test_flow_stream_warm_matches_cold_at_reduced_budget():
    """Temporal warm start (round 4): on a coherent synthetic pan, warm
    iters=25 must reach (or beat) cold iters=100 accuracy from the second
    pair on, and the first pair must equal a plain cold solve."""
    import jax.numpy as jnp
    import numpy as np

    from hsflow.config import HSConfig
    from hsflow.data.synthetic import synthetic_sequence
    from hsflow.solver import hs_solve
    from hsflow.video import flow_stream_warm

    frames, gt = synthetic_sequence(6, 64, 80, tx=1.0, ty=0.5, key=3)
    cfg_warm = HSConfig(alpha=0.2, iters=25, backend="jnp")
    cfg_cold = HSConfig(alpha=0.2, iters=100, backend="jnp")

    warm = list(flow_stream_warm(frames, cfg_warm, chunk=3))
    assert len(warm) == 5

    # first pair == plain cold solve at the same budget (no prior exists)
    ref0 = hs_solve(jnp.asarray(frames[0]), jnp.asarray(frames[1]), cfg_warm)
    assert float(jnp.abs(warm[0].u - ref0.u).max()) == 0.0

    def interior_err(flow):
        u = np.asarray(flow.u)[8:-8, 8:-8]
        v = np.asarray(flow.v)[8:-8, 8:-8]
        return float(np.sqrt((u - gt[0]) ** 2 + (v - gt[1]) ** 2).mean())

    cold_last = hs_solve(
        jnp.asarray(frames[4]), jnp.asarray(frames[5]), cfg_cold
    )
    e_warm = interior_err(warm[-1])
    e_cold100 = interior_err(cold_last)
    # 25 warm iters at pair 5 should be at least as accurate as 100 cold
    assert e_warm <= e_cold100 * 1.05, (e_warm, e_cold100)


def test_flow_stream_warm_composes_with_tol():
    """Warm start + solve-to-tolerance: the natural streaming mode — each
    pair stops as soon as the warm-started solve converges."""
    import jax.numpy as jnp

    from hsflow.config import HSConfig
    from hsflow.data.synthetic import synthetic_sequence
    from hsflow.video import flow_stream_warm

    frames, gt = synthetic_sequence(4, 48, 64, tx=1.0, ty=0.0, key=9)
    cfg = HSConfig(alpha=0.2, iters=200, tol=5e-4, block_sweeps=8,
                   backend="jnp")
    flows = list(flow_stream_warm(frames, cfg, chunk=2))
    assert len(flows) == 3
    u = flows[-1].u[8:-8, 8:-8]
    assert abs(float(jnp.mean(u)) - 1.0) < 0.35  # converged toward GT


def test_flow_stream_warm_warp_prior_recovers_large_motion():
    """warp_prior=True: after the pyramid bootstrap, each pair is one
    cheap full-res residual solve, and a 3 px/frame pan — far beyond the
    HS linearization range — stays locked, where the init-only warm start
    loses it."""
    import numpy as np

    from hsflow.config import HSConfig
    from hsflow.data.synthetic import synthetic_sequence
    from hsflow.video import flow_stream_warm

    frames, gt = synthetic_sequence(5, 96, 128, tx=3.0, ty=0.0, key=4,
                                    max_freq=0.08)
    cfg = HSConfig(alpha=0.2, iters=40, backend="jnp")

    def err(flow):
        u = np.asarray(flow.u)[12:-12, 12:-12]
        v = np.asarray(flow.v)[12:-12, 12:-12]
        return float(np.sqrt((u - gt[0]) ** 2 + (v - gt[1]) ** 2).mean())

    warp = list(flow_stream_warm(frames, cfg, chunk=4, warp_prior=True))
    init = list(flow_stream_warm(frames, cfg, chunk=4))
    e_warp = err(warp[-1])
    e_init = err(init[-1])
    assert e_warp < 0.5, e_warp
    assert e_warp < e_init * 0.5, (e_warp, e_init)


def test_flow_stream_warm_fused_scan_matches_per_call():
    """Round-5 VERDICT item 5: the fused lax.scan warm chain (one dispatch
    per prefetch window) must reproduce the per-pair dispatch path exactly
    — same warm chain, same arithmetic — in both init-only and warp-prior
    modes, across window boundaries (the carry crosses windows)."""
    import numpy as np

    from hsflow.config import HSConfig
    from hsflow.data.synthetic import synthetic_sequence
    from hsflow.video import flow_stream_warm

    frames, _ = synthetic_sequence(9, 48, 64, tx=0.8, ty=-0.4, key=5)
    cfg = HSConfig(alpha=0.3, iters=20, backend="jnp")
    for warp_prior in (False, True):
        fused = [
            np.stack([np.asarray(f.u), np.asarray(f.v)])
            for f in flow_stream_warm(frames, cfg, chunk=3, fused=True,
                                      warp_prior=warp_prior)
        ]
        plain = [
            np.stack([np.asarray(f.u), np.asarray(f.v)])
            for f in flow_stream_warm(frames, cfg, chunk=3, fused=False,
                                      warp_prior=warp_prior)
        ]
        assert len(fused) == len(plain) == 8
        for k, (a, b) in enumerate(zip(fused, plain)):
            assert float(np.abs(a - b).max()) <= 1e-5, (warp_prior, k)
