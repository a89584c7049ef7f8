"""Tiled-vs-untiled equivalence (SURVEY.md §4 rung 5 — the distributed-
correctness invariant): Jacobi order-independence means the shard_map tiled
solve must match the single-device solve to float tolerance at any mesh
shape, any halo block size, batched or not."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hsflow.config import HSConfig, MeshConfig
from hsflow.data.synthetic import translation_pair
from hsflow.dist import hs_solve_tiled, make_mesh
from hsflow.solver import hs_solve

CFG = HSConfig(alpha=0.5, iters=24, backend="jnp")


@pytest.fixture(scope="module")
def pair():
    i1, i2, _ = translation_pair(32, 64, 1.0, 0.5, key=11)
    return jnp.asarray(i1), jnp.asarray(i2)


def _untiled(i1, i2):
    f = hs_solve(i1, i2, CFG)
    return np.asarray(f.u), np.asarray(f.v)


@pytest.mark.parametrize("my,mx", [(1, 1), (2, 2), (1, 8), (8, 1), (2, 4)])
def test_tiled_matches_untiled(pair, my, mx):
    i1, i2 = pair
    mesh = make_mesh(MeshConfig(batch=1, y=my, x=mx))
    f = hs_solve_tiled(i1, i2, CFG, mesh=mesh)
    u, v = _untiled(i1, i2)
    np.testing.assert_allclose(np.asarray(f.u), u, atol=1e-6)
    np.testing.assert_allclose(np.asarray(f.v), v, atol=1e-6)


@pytest.mark.parametrize("s", [1, 2, 3, 5])
def test_blockwise_halo_matches_untiled(pair, s):
    """s-sweep halo blocks (including iters % s != 0 remainders)."""
    i1, i2 = pair
    mesh = make_mesh(MeshConfig(batch=1, y=2, x=4))
    f = hs_solve_tiled(i1, i2, CFG, mesh=mesh, halo_sweeps=s)
    u, v = _untiled(i1, i2)
    np.testing.assert_allclose(np.asarray(f.u), u, atol=1e-6)
    np.testing.assert_allclose(np.asarray(f.v), v, atol=1e-6)


def test_batched_tiled_dp_tp(pair):
    """DP x TP: (B, H, W) stack over a full (2, 2, 2) mesh."""
    i1, i2 = pair
    b1 = jnp.stack([i1, i2, i1 * 0.5, i2 * 0.5])
    b2 = jnp.stack([i2, i1, i2 * 0.5, i1 * 0.5])
    mesh = make_mesh(MeshConfig(batch=2, y=2, x=2))
    f = hs_solve_tiled(b1, b2, CFG, mesh=mesh, halo_sweeps=2)
    for k in range(b1.shape[0]):
        fu, fv = _untiled(b1[k], b2[k])
        np.testing.assert_allclose(np.asarray(f.u[k]), fu, atol=1e-6)
        np.testing.assert_allclose(np.asarray(f.v[k]), fv, atol=1e-6)


def test_tiled_validation_errors(pair):
    i1, i2 = pair
    mesh = make_mesh(MeshConfig(batch=1, y=2, x=4))
    with pytest.raises(ValueError, match="requires a Mesh"):
        hs_solve_tiled(i1, i2, CFG)
    with pytest.raises(ValueError, match="too small"):
        hs_solve_tiled(i1, i2, CFG, mesh=mesh, halo_sweeps=100)


@pytest.mark.parametrize("mesh_yx", [(2, 4), (8, 1), (1, 8), (2, 2)])
@pytest.mark.parametrize("shape", [(37, 115), (63, 61)])
def test_tiled_arbitrary_shape_matches_untiled(mesh_yx, shape, kernel_mode):
    """Prime-ish shapes that do NOT divide the mesh: pad-and-mask inside the
    shard body must reproduce the untiled solve exactly (no silent crop)."""
    h, w = shape
    rng = np.random.default_rng(5)
    i1 = jnp.asarray(rng.uniform(0, 1, (h, w)).astype(np.float32))
    i2 = jnp.asarray(rng.uniform(0, 1, (h, w)).astype(np.float32))
    mesh = make_mesh(MeshConfig(batch=1, y=mesh_yx[0], x=mesh_yx[1]))
    ref = hs_solve(i1, i2, HSConfig(alpha=0.5, iters=12, backend="jnp"))
    u, v = np.asarray(ref.u), np.asarray(ref.v)
    for backend, s in (("jnp", 1), ("jnp", 3), ("pallas", 2)):
        cfg = HSConfig(alpha=0.5, iters=12, backend=backend)
        f = hs_solve_tiled(i1, i2, cfg, mesh=mesh, halo_sweeps=s)
        assert f.u.shape == (h, w)
        np.testing.assert_allclose(np.asarray(f.u), u, atol=2e-6)
        np.testing.assert_allclose(np.asarray(f.v), v, atol=2e-6)


@pytest.mark.parametrize("s", [1, 3])
def test_tiled_pallas_backend_matches_untiled(pair, s, kernel_mode):
    """Per-shard kernel (interpret mode on CPU) == untiled jnp."""
    i1, i2 = pair
    cfg = HSConfig(alpha=0.5, iters=24, backend="pallas")
    mesh = make_mesh(MeshConfig(batch=1, y=2, x=4))
    f = hs_solve_tiled(i1, i2, cfg, mesh=mesh, halo_sweeps=s)
    u, v = _untiled(i1, i2)
    np.testing.assert_allclose(np.asarray(f.u), u, atol=2e-6)
    np.testing.assert_allclose(np.asarray(f.v), v, atol=2e-6)


def test_batched_tiled_pallas_composition(pair, kernel_mode):
    """DP x TP x per-shard kernel (vmap over shard_map over pallas_call) ==
    untiled jnp."""
    i1, i2 = pair
    b1 = jnp.stack([i1, i2])
    b2 = jnp.stack([i2, i1])
    cfg = HSConfig(alpha=0.5, iters=12, backend="pallas")
    mesh = make_mesh(MeshConfig(batch=2, y=2, x=2))
    f = hs_solve_tiled(b1, b2, cfg, mesh=mesh, halo_sweeps=2)
    for k in range(2):
        ref = hs_solve(b1[k], b2[k], HSConfig(alpha=0.5, iters=12, backend="jnp"))
        np.testing.assert_allclose(np.asarray(f.u[k]), np.asarray(ref.u), atol=2e-6)
