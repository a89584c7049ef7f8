"""P5 reshard invariance and P3 time-sharded pair construction tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from hsflow.config import HSConfig, MeshConfig
from hsflow.dist import make_mesh
from hsflow.dist.reshard import (
    space_to_time,
    time_to_space,
    timesharded_pairs,
)
from hsflow.solver import hs_solve


def _frames(t=8, h=16, w=32):
    rng = np.random.default_rng(5)
    return jnp.asarray(rng.uniform(0, 1, (t, h, w)).astype(np.float32))


def test_reshard_roundtrip_preserves_values():
    mesh = make_mesh(MeshConfig(batch=2, y=2, x=2))
    frames = _frames()
    sh_time = NamedSharding(mesh, P("batch", None, None))
    x = jax.device_put(frames, sh_time)

    @jax.jit
    def roundtrip(a):
        b = time_to_space(a, mesh)
        b = b * 1.0  # force materialization in the space layout
        return space_to_time(b, mesh)

    out = roundtrip(x)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(frames))
    assert out.sharding.is_equivalent_to(sh_time, out.ndim)


def test_timesharded_pairs_cover_all_pairs():
    """Union of valid local pairs == the T-1 global consecutive pairs."""
    mesh = make_mesh(MeshConfig(batch=4, y=1, x=1))
    frames = _frames(t=8)

    def body(fr):
        i1, i2, valid = timesharded_pairs(fr)
        return i1[None], i2[None], valid[None]

    fn = jax.jit(
        jax.shard_map(
            body,
            mesh=mesh,
            in_specs=P("batch", None, None),
            out_specs=(
                P("batch", None, None, None),
                P("batch", None, None, None),
                P("batch", None),
            ),
        )
    )
    arr = jax.device_put(frames, NamedSharding(mesh, P("batch", None, None)))
    i1s, i2s, valids = fn(arr)
    i1s = np.asarray(i1s).reshape(-1, 16, 32)
    i2s = np.asarray(i2s).reshape(-1, 16, 32)
    valids = np.asarray(valids).reshape(-1)
    assert valids.sum() == 7  # T-1 valid pairs
    want1 = np.asarray(frames[:-1])
    want2 = np.asarray(frames[1:])
    np.testing.assert_array_equal(i1s[valids], want1)
    np.testing.assert_array_equal(i2s[valids], want2)


def test_timesharded_flow_matches_unsharded():
    """End-to-end SP: solve pairs under time sharding == plain batched solve."""
    cfg = HSConfig(alpha=0.5, iters=12, backend="jnp")
    mesh = make_mesh(MeshConfig(batch=4, y=1, x=1))
    frames = _frames(t=8)

    def body(fr):
        i1, i2, valid = timesharded_pairs(fr)
        from hsflow.solver import precompute, sweeps

        def single(a, b):
            ex, ey, et, invd = precompute(a, b, cfg)
            z = jnp.zeros_like(ex)
            return sweeps(z, z, ex, ey, et, invd, cfg.iters, cfg)

        f = jax.vmap(single)(i1, i2)
        return f.u[None], f.v[None], valid[None]

    fn = jax.jit(
        jax.shard_map(
            body,
            mesh=mesh,
            in_specs=P("batch", None, None),
            out_specs=(
                P("batch", None, None, None),
                P("batch", None, None, None),
                P("batch", None),
            ),
        )
    )
    arr = jax.device_put(frames, NamedSharding(mesh, P("batch", None, None)))
    us, vs, valids = fn(arr)
    us = np.asarray(us).reshape(-1, 16, 32)[np.asarray(valids).reshape(-1)]
    for k in range(7):
        ref = hs_solve(frames[k], frames[k + 1], cfg)
        np.testing.assert_allclose(us[k], np.asarray(ref.u), atol=1e-6)


def test_time_to_space_lowers_to_slice_allgather_no_remat(capfd):
    """The round-2 VERDICT finding: bare with_sharding_constraint made GSPMD
    fall back to 'involuntary full rematerialization' (replicate the whole
    stack, then re-partition). The explicit shard_map lowering must (a) emit
    the pre-sliced all-gather, (b) never replicate the full tensor, and (c)
    leave no SPMD remat warning on stderr."""
    mesh = make_mesh(MeshConfig(batch=2, y=2, x=2))
    frames = _frames()
    x = jax.device_put(frames, NamedSharding(mesh, P("batch", None, None)))

    fn = jax.jit(lambda a: time_to_space(a, mesh))
    compiled = fn.lower(x).compile()
    hlo = compiled.as_text()
    assert "all-gather" in hlo, "expected an all-gather collective"
    out = fn(x)
    jax.block_until_ready(out)
    err = capfd.readouterr().err
    assert "Involuntary full rematerialization" not in err
    np.testing.assert_array_equal(np.asarray(out), np.asarray(frames))
    assert out.sharding.is_equivalent_to(
        NamedSharding(mesh, P(None, "y", "x")), out.ndim
    )


def test_reshard_roundtrip_odd_shapes():
    """Pad-and-crop path: spatial shapes that don't divide the mesh grid
    round-trip exactly (T must divide the batch axis — device_put refuses
    uneven shardings on the sharded input dim)."""
    mesh = make_mesh(MeshConfig(batch=2, y=2, x=2))
    rng = np.random.default_rng(11)
    frames = jnp.asarray(rng.uniform(0, 1, (6, 13, 19)).astype(np.float32))
    x = jax.device_put(frames, NamedSharding(mesh, P("batch", None, None)))

    @jax.jit
    def roundtrip(a):
        return space_to_time(time_to_space(a, mesh) * 1.0, mesh)

    out = roundtrip(x)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(frames))
