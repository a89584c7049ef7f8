"""Solver behaviour on the kernel backend, through the user entry points.

Each case runs `backend="pallas"` (the GPU kernel; the Pallas interpreter
on the CPU via the `kernel_mode` fixture) against `backend="jnp"`: warm
start, per-level pyramid budgets, solve-to-tolerance blocks, batched stacks,
derivative variants, the non-Jacobi families (jnp on every backend) and the
warm video stream.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from hsflow.batch import hs_solve_batched
from hsflow.config import HSConfig, PyramidConfig
from hsflow.data.synthetic import translation_pair, two_motion_pair
from hsflow.ops import golden
from hsflow.pyramid import hs_pyramid
from hsflow.solver import Flow, hs_solve


def _pair(h, w, seed=3, dx=1.0, dy=0.5):
    i1, i2, _ = translation_pair(h, w, dx, dy, key=seed)
    return jnp.asarray(i1), jnp.asarray(i2)


def _close(a: Flow, b: Flow, tol=2e-6):
    assert a.u.shape == b.u.shape
    assert float(jnp.abs(a.u - b.u).max()) <= tol
    assert float(jnp.abs(a.v - b.v).max()) <= tol


@pytest.mark.parametrize("shape", [(48, 64), (37, 51)])
@pytest.mark.parametrize("variant", ["hs_cube", "central"])
@pytest.mark.parametrize("alpha", [0.3, 1.0])
def test_solve_matches_jnp(kernel_mode, shape, variant, alpha):
    i1, i2 = _pair(*shape)
    kw = dict(alpha=alpha, iters=14, deriv_variant=variant)
    _close(hs_solve(i1, i2, HSConfig(backend="pallas", **kw)),
           hs_solve(i1, i2, HSConfig(backend="jnp", **kw)))


@pytest.mark.parametrize("shape", [(32, 48), (21, 35)])
def test_solve_matches_numpy_golden(kernel_mode, shape):
    """Kernel solve == the float64 NumPy reference (ops/golden.py)."""
    i1, i2 = _pair(*shape, seed=5)
    f = hs_solve(i1, i2, HSConfig(alpha=0.5, iters=20, backend="pallas"))
    gu, gv = golden.hs_numpy(np.asarray(i1), np.asarray(i2), 0.5, 20)
    assert float(np.abs(np.asarray(f.u) - gu).max()) <= 1e-5
    assert float(np.abs(np.asarray(f.v) - gv).max()) <= 1e-5


@pytest.mark.parametrize("first,second", [(5, 9), (6, 6), (1, 13)])
def test_warm_start_resumes_exactly(kernel_mode, first, second):
    """init=Flow continues the sweep sequence: a split solve equals the
    single solve of first+second sweeps (checkpoint resume, warm video)."""
    i1, i2 = _pair(40, 56)
    cfg = HSConfig(alpha=0.5, iters=first, backend="pallas")
    part = hs_solve(i1, i2, cfg)
    resumed = hs_solve(i1, i2, HSConfig(alpha=0.5, iters=second,
                                        backend="pallas"), init=part)
    full = hs_solve(i1, i2, HSConfig(alpha=0.5, iters=first + second,
                                     backend="jnp"))
    _close(resumed, full)


@pytest.mark.parametrize("per_level", [(8, 4), (3, 11, 6)])
def test_pyramid_per_level_budgets(kernel_mode, per_level):
    i1, i2 = _pair(64, 96, seed=9, dx=3.0, dy=0.0)
    pyr = PyramidConfig(levels=len(per_level), iters_per_level=per_level)
    _close(hs_pyramid(i1, i2, HSConfig(alpha=0.5, backend="pallas"), pyr),
           hs_pyramid(i1, i2, HSConfig(alpha=0.5, backend="jnp"), pyr),
           tol=5e-6)


@pytest.mark.parametrize("block", [2, 5])
def test_tol_blocks_match_jnp(kernel_mode, block):
    """Solve-to-tolerance runs kernel passes as its check blocks and stops
    at the same block as the jnp path."""
    i1, i2 = _pair(32, 48, seed=4)
    kw = dict(alpha=0.5, iters=60, tol=2e-3, block_sweeps=block)
    _close(hs_solve(i1, i2, HSConfig(backend="pallas", **kw)),
           hs_solve(i1, i2, HSConfig(backend="jnp", **kw)), tol=5e-6)


@pytest.mark.parametrize("b,shape", [(1, (24, 40)), (3, (19, 33)),
                                     (2, (64, 128))])
def test_batched_matches_per_frame(kernel_mode, b, shape):
    rng = np.random.default_rng(b)
    i1 = jnp.asarray(rng.uniform(0, 1, (b,) + shape).astype(np.float32))
    i2 = jnp.asarray(rng.uniform(0, 1, (b,) + shape).astype(np.float32))
    cfg = HSConfig(alpha=0.5, iters=9, backend="pallas")
    fb = hs_solve_batched(i1, i2, cfg)
    for k in range(b):
        _close(Flow(fb.u[k], fb.v[k]),
               hs_solve(i1[k], i2[k], HSConfig(alpha=0.5, iters=9,
                                               backend="jnp")))


def test_batched_tol_stops_on_the_whole_stack(kernel_mode):
    """On the kernel backend a stack stops when its SLOWEST frame meets
    tol: an easy frame next to a hard one runs the hard one's blocks."""
    easy = _pair(24, 40, seed=1, dx=0.0, dy=0.0)
    hard = _pair(24, 40, seed=2, dx=1.0, dy=0.5)
    b1 = jnp.stack([easy[0], hard[0]])
    b2 = jnp.stack([easy[1], hard[1]])
    kw = dict(alpha=0.5, iters=80, tol=1e-3, block_sweeps=4)
    fb = hs_solve_batched(b1, b2, HSConfig(backend="pallas", **kw))
    hard_alone = hs_solve(hard[0], hard[1], HSConfig(backend="jnp", **kw))
    _close(Flow(fb.u[1], fb.v[1]), hard_alone, tol=5e-6)


@pytest.mark.parametrize("solver_name", ["sor", "multigrid", "robust"])
def test_other_families_are_jnp_on_kernel_backend(kernel_mode, solver_name):
    """SOR, multigrid and robust relaxation are plain jnp on every backend:
    the pallas setting must not change their result."""
    i1, i2, _ = two_motion_pair(32, 48, (1.0, 0.0), (-1.0, 0.5), key=2)
    i1, i2 = jnp.asarray(i1), jnp.asarray(i2)
    kw = dict(alpha=0.4, iters=4 if solver_name == "multigrid" else 12,
              solver=solver_name, omega=1.5)
    _close(hs_solve(i1, i2, HSConfig(backend="pallas", **kw)),
           hs_solve(i1, i2, HSConfig(backend="jnp", **kw)), tol=0.0)


def test_warm_stream_matches_per_call(kernel_mode):
    """flow_stream_warm's fused scan == per-pair warm solves on the kernel
    backend (the c4 path)."""
    from hsflow.data.synthetic import synthetic_sequence
    from hsflow.video import flow_stream_warm

    frames = np.asarray(synthetic_sequence(5, 24, 40, key=1)[0])
    cfg = HSConfig(alpha=0.5, iters=6, backend="pallas")
    fused = list(flow_stream_warm(frames, cfg, chunk=4, fused=True))
    plain = list(flow_stream_warm(frames, cfg, chunk=4, fused=False))
    assert len(fused) == len(plain) == 4
    for a, b in zip(fused, plain):
        _close(a, b, tol=0.0)
