"""GPU Jacobi kernel (kernels/jacobi.py) vs the jnp oracle, in the Pallas
interpreter on the CPU.

The compiled kernel runs only on the card (tests marked `gpu`, and
chip_smoke.py); here the same kernel body runs interpreted, so the tile
geometry, halo decay, true-edge masks, pass schedule and batch axis are all
checked against `ops.stencils.jacobi_step`. The interpreter evaluates the
same association order, so agreement is to a few ulp (FMA contraction).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hsflow.kernels import jacobi as jk
from hsflow.ops import stencils

TOL = 1e-6


def _fields(shape, seed=0, alpha=0.5, warm=False):
    rng = np.random.default_rng(seed)
    i1 = jnp.asarray(rng.uniform(0, 1, shape).astype(np.float32))
    i2 = jnp.asarray(rng.uniform(0, 1, shape).astype(np.float32))
    ex, ey, et = stencils.derivatives(i1, i2)
    invd = 1.0 / (alpha * alpha + ex * ex + ey * ey)
    if warm:
        u = jnp.asarray(rng.normal(size=shape).astype(np.float32))
        v = jnp.asarray(rng.normal(size=shape).astype(np.float32))
    else:
        u = jnp.zeros_like(ex)
        v = jnp.zeros_like(ex)
    return u, v, ex, ey, et, invd


def _oracle(u, v, ex, ey, et, invd, n):
    for _ in range(n):
        u, v = stencils.jacobi_step(u, v, ex, ey, et, invd)
    return u, v


def _close(out, ref, tol=TOL):
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        assert float(jnp.abs(a - b).max()) <= tol


@pytest.mark.parametrize(
    "shape", [(64, 128), (37, 51), (67, 93), (129, 257), (8, 128), (1, 40),
              (40, 1), (1, 1)]
)
@pytest.mark.parametrize("n", [1, 7, 25])
def test_kernel_matches_jnp(shape, n):
    """Default pass depth on aligned, odd and degenerate (1-row, 1-column,
    1-pixel) frames: every true-edge clamp path."""
    f = _fields(shape, seed=n)
    out = jk.jacobi_sweeps(*f, n, interpret=True)
    _close(out, _oracle(*f, n))


@pytest.mark.parametrize("shape", [(300, 140), (70, 260)])
@pytest.mark.parametrize(
    "n,k", [(1, 0), (3, 2), (7, 3), (6, 0), (13, 4), (20, 16)]
)
def test_block_sweeps_match_jnp(shape, n, k):
    """block_sweeps = k sweeps per pass (0 = auto), with remainder passes;
    multi-tile frames so halos cross tile seams."""
    f = _fields(shape, seed=k)
    out = jk.jacobi_sweeps(*f, n, block_sweeps=k, interpret=True)
    _close(out, _oracle(*f, n))


@pytest.mark.parametrize("shape", [(37, 51), (96, 200), (5, 300)])
def test_warm_start_matches_jnp(shape):
    """Non-zero u0/v0 (pyramid residual solves, video warm start)."""
    f = _fields(shape, seed=3, warm=True)
    out = jk.jacobi_sweeps(*f, 9, block_sweeps=4, interpret=True)
    _close(out, _oracle(*f, 9), tol=4e-6)


@pytest.mark.parametrize(
    "b,shape,k", [(3, (37, 51), 0), (2, (64, 128), 3), (5, (16, 40), 2),
                  (1, (70, 130), 5)]
)
def test_batched_matches_per_image(b, shape, k):
    """(B, H, W) stacks run the batch as a grid axis."""
    rng = np.random.default_rng(b)
    stacks = [jnp.asarray(rng.uniform(-1, 1, (b,) + shape).astype(np.float32))
              for _ in range(5)]
    u, v, ex, ey, et = stacks
    invd = 1.0 / (0.25 + ex * ex + ey * ey)
    uo, vo = jk.jacobi_sweeps(u, v, ex, ey, et, invd, 7, block_sweeps=k,
                              interpret=True)
    for i in range(b):
        ur, vr = _oracle(u[i], v[i], ex[i], ey[i], et[i], invd[i], 7)
        _close((uo[i], vo[i]), (ur, vr))


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_random_shapes_vs_oracle(seed):
    rng = np.random.default_rng(100 + seed)
    shape = (int(rng.integers(1, 150)), int(rng.integers(1, 300)))
    n = int(rng.integers(1, 12))
    k = int(rng.integers(0, 8))
    f = _fields(shape, seed=seed, warm=bool(seed % 2))
    out = jk.jacobi_sweeps(*f, n, block_sweeps=k, interpret=True)
    _close(out, _oracle(*f, n), tol=4e-6)


def test_vmap_matches_batch_axis():
    """vmap over the 2-D kernel (pallas_call batching rule) == the native
    batch grid axis."""
    rng = np.random.default_rng(5)
    stacks = [jnp.asarray(rng.uniform(-1, 1, (3, 20, 30)).astype(np.float32))
              for _ in range(5)]
    u, v, ex, ey, et = stacks
    invd = 1.0 / (0.25 + ex * ex + ey * ey)
    ref = jk.jacobi_sweeps(u, v, ex, ey, et, invd, 5, interpret=True)
    out = jax.vmap(
        lambda *a: jk.jacobi_sweeps(*a, 5, interpret=True)
    )(u, v, ex, ey, et, invd)
    _close(out, ref, tol=0.0)


def test_kernel_inside_scan_carry():
    """The warm video stream runs the kernel inside a lax.scan body with
    the flow as carry: same result as chained calls."""
    f = _fields((24, 40), seed=8)
    u, v, ex, ey, et, invd = f

    def body(c, _):
        return jk.jacobi_sweeps(*c, ex, ey, et, invd, 3, interpret=True), None

    (us, vs), _ = jax.lax.scan(body, (u, v), None, length=3)
    _close((us, vs), _oracle(*f, 9))


def test_zero_sweeps_is_identity():
    f = _fields((12, 20), warm=True)
    out = jk.jacobi_sweeps(*f, 0, interpret=True)
    assert out[0] is f[0] and out[1] is f[1]


def test_empty_batch_is_identity():
    z = jnp.zeros((0, 8, 8), jnp.float32)
    out = jk.jacobi_sweeps(z, z, z, z, z, z, 4, interpret=True)
    assert out[0].shape == (0, 8, 8)


def test_rejects_bad_rank():
    z = jnp.zeros((2, 2, 8, 8), jnp.float32)
    with pytest.raises(ValueError, match="expects"):
        jk.jacobi_sweeps(z, z, z, z, z, z, 4, interpret=True)


def test_compiled_kernel_is_an_error_off_gpu():
    """No silent interpreter: without interpret mode the kernel needs a
    GPU (this suite runs on the CPU)."""
    f = _fields((8, 8))
    with pytest.raises(ValueError, match="GPU"):
        jk.jacobi_sweeps(*f, 2)
    with pytest.raises(ValueError, match="GPU"):
        jk.tile_sweeps(*f, 2, 0, 0, 8, 8)


def test_interpret_context_is_scoped():
    assert not jk.interpreting()
    with jk.interpret_mode():
        assert jk.interpreting()
        f = _fields((8, 8))
        _close(jk.jacobi_sweeps(*f, 2), _oracle(*f, 2))
    assert not jk.interpreting()


@pytest.mark.parametrize("shape", [(32, 144), (17, 40), (70, 130)])
def test_bf16_matches_bf16_jnp(shape):
    """Fields in bfloat16: the kernel computes in the field dtype; agreement
    is to bf16 rounding."""
    f = [a.astype(jnp.bfloat16) for a in _fields(shape, seed=6)]
    uo, vo = jk.jacobi_sweeps(*f, 4, interpret=True)
    ur, vr = _oracle(*f, 4)
    assert uo.dtype == jnp.bfloat16
    assert float(jnp.abs(uo.astype(jnp.float32) - ur.astype(jnp.float32)).max()) <= 1e-2
    assert float(jnp.abs(vo.astype(jnp.float32) - vr.astype(jnp.float32)).max()) <= 1e-2


@pytest.mark.parametrize("alpha", [1e-3, 100.0])
def test_extreme_regularization(alpha):
    """Data-dominated (tiny alpha) and smoothness-dominated (huge alpha)
    systems: 1/den spans many orders of magnitude."""
    f = _fields((40, 70), seed=7, alpha=alpha)
    out = jk.jacobi_sweeps(*f, 6, interpret=True)
    ref = _oracle(*f, 6)
    scale = max(1.0, float(jnp.abs(ref[0]).max()))
    _close(out, ref, tol=2e-6 * scale)


def test_2d_equals_batch_of_one():
    f = _fields((33, 47), seed=8, warm=True)
    two_d = jk.jacobi_sweeps(*f, 5, interpret=True)
    batch = jk.jacobi_sweeps(*(a[None] for a in f), 5, interpret=True)
    _close(two_d, (batch[0][0], batch[1][0]), tol=0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1080, 1920), (37, 51)])
def test_compiled_kernel_matches_jnp(shape):
    """The compiled kernel on the card == jnp (chip_smoke.py runs this)."""
    f = _fields(shape, seed=4)
    out = jax.jit(lambda *a: jk.jacobi_sweeps(*a, 20))(*f)
    ref = jax.jit(lambda *a: _oracle(*a, 20))(*f)
    _close(out, ref, tol=1e-5)
