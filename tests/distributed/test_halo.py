"""Halo-exchange unit tests (SURVEY.md §4 tests/distributed).

Labeled-grid ppermute test: shard a globally-labeled image, halo_pad each
tile, and assert every received halo pixel equals the correct global
neighbor — including corners (two-phase exchange) and replicate-clamped
global edges.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hsflow.config import MeshConfig
from hsflow.dist.halo import halo_pad
from hsflow.dist.mesh import make_mesh, mesh_for_devices


def _labeled(h, w):
    return (
        np.arange(h)[:, None] * 1000.0 + np.arange(w)[None, :]
    ).astype(np.float32)


@pytest.mark.parametrize("my,mx", [(1, 1), (2, 2), (2, 4), (4, 2), (1, 8)])
@pytest.mark.parametrize("s", [1, 2, 3])
def test_halo_pad_labeled_grid(my, mx, s):
    h, w = 16 * my, 16 * mx
    mesh = make_mesh(MeshConfig(batch=1, y=my, x=mx))
    g = _labeled(h, w)
    th, tw = h // my, w // mx

    fn = jax.jit(
        jax.shard_map(
            lambda t: halo_pad(t, s)[None, None],
            mesh=mesh,
            in_specs=P("y", "x"),
            out_specs=P("y", "x", None, None),
        )
    )
    arr = jax.device_put(jnp.asarray(g), NamedSharding(mesh, P("y", "x")))
    out = np.asarray(fn(arr))  # (my, mx, th+2s, tw+2s)

    gpad = np.pad(g, s, mode="edge")
    for i in range(my):
        for j in range(mx):
            want = gpad[i * th : i * th + th + 2 * s, j * tw : j * tw + tw + 2 * s]
            np.testing.assert_array_equal(out[i, j], want, err_msg=f"tile ({i},{j})")


def test_mesh_for_devices_factorization():
    assert mesh_for_devices(8).shape == (1, 2, 4)
    assert mesh_for_devices(8, batch=2).shape == (2, 2, 2)
    assert mesh_for_devices(1).shape == (1, 1, 1)
    with pytest.raises(ValueError):
        mesh_for_devices(8, batch=3)


def test_make_mesh_too_many_devices():
    with pytest.raises(ValueError):
        make_mesh(MeshConfig(batch=2, y=4, x=4))


def test_make_mesh_axis_names():
    mesh = make_mesh(MeshConfig(batch=2, y=2, x=2))
    assert mesh.axis_names == ("batch", "y", "x")
    assert isinstance(mesh, Mesh)
