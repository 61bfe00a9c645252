"""Mesh extraction (utils/mesh_extract.py) on the CPU against the JAX
package's: the numpy marching tetrahedra, the native library built from
native/marching_tets.cpp, ``mesh_from_volume`` on a 16^3 field and
``extract_mesh`` over a density function (the hash field's export), compared
as triangle sets after welding; and the OBJ/PLY writers."""

import numpy as np
import pytest
import torch

from focnerf_tpu.render import baked as jb
from focnerf_tpu.utils import mesh_extract as jm
from focnerf_tpu_torch.render import baked as tb
from focnerf_tpu_torch.utils import mesh_extract as tm


def field16():
    """Two overlapping blobs with a ripple, sigma [16, 16, 16]."""
    c = (np.arange(16, dtype=np.float32) + 0.5) / 16 * 2 - 1
    X, Y, Z = np.meshgrid(c, c, c, indexing="ij")
    s = 30 * np.exp(-((X - 0.2) ** 2 + Y**2 + Z**2) / 0.1) + 20 * np.exp(-((X + 0.3) ** 2 + (Y - 0.3) ** 2) / 0.05)
    return (s + 2 * np.sin(7 * X) * np.cos(5 * Z)).astype(np.float32)


def triangle_set(verts, faces):
    """Each triangle as its sorted vertex coordinates, rounded; a sorted array."""
    tris = np.round(verts[faces], 5)
    tris = np.sort(tris.view([("", tris.dtype)] * 3).reshape(-1, 3), axis=1).view(tris.dtype).reshape(-1, 9)
    return tris[np.lexsort(tris.T[::-1])]


def test_numpy_marching_tets_equals_jax():
    grid = field16()
    for iso in (5.0, 12.5):
        got = tm._marching_tets_numpy(grid, iso)
        want = jm._marching_tets_numpy(grid, iso)
        assert got.shape == want.shape and len(got) > 100
        np.testing.assert_array_equal(got, want)


def test_native_equals_numpy_after_welding():
    lib = tm.native_lib()
    if lib is None:
        pytest.fail(f"the native marching tetrahedra did not build: "
                    f"{tm.build_native(tm.NATIVE_SOURCE, 'marching_tets')[1]}")
    grid = field16()
    got = tm.marching_tets(grid, 10.0)
    want = tm._marching_tets_numpy(grid, 10.0)
    assert got.shape == want.shape
    np.testing.assert_array_equal(triangle_set(*tm.weld_vertices(got)), triangle_set(*tm.weld_vertices(want)))


def test_mesh_from_volume_matches_jax(tmp_path):
    rgba = np.concatenate([np.full((16, 16, 16, 3), 0.5, np.float32), field16()[..., None]], -1)
    got = tm.mesh_from_volume(tb.BakedVolume(rgba=torch.from_numpy(rgba), bound=1.5), 10.0)
    want = jm.mesh_from_volume(jb.BakedVolume(rgba=rgba, bound=1.5), 10.0)
    assert len(got[1]) > 100 and np.abs(got[0]).max() <= 1.5
    np.testing.assert_array_equal(triangle_set(*got), triangle_set(*want))

    tm.save_obj(str(tmp_path / "t.obj"), *got)
    jm.save_obj(str(tmp_path / "j.obj"), *want)
    lines = open(tmp_path / "t.obj").read().splitlines()
    assert sum(line.startswith("v ") for line in lines) == len(got[0])
    assert sum(line.startswith("f ") for line in lines) == len(got[1])
    tm.save_ply(str(tmp_path / "t.ply"), *got)
    jm.save_ply(str(tmp_path / "j.ply"), *got)
    assert open(tmp_path / "t.ply", "rb").read() == open(tmp_path / "j.ply", "rb").read()


def test_extract_mesh_matches_jax(tmp_path):
    """The hash field's export: a density function sampled on a 24^3 grid
    over [-1.5, 1.5]^3, meshed at 10. A polynomial field, so both packages
    compute the same fp32 grid; then the same triangle set."""
    import jax.numpy as jnp

    def sigma(x, sum_):
        r2 = sum_(x * x)
        return 30.0 - 25.0 * r2 + 6.0 * x[..., 0] * x[..., 1]

    got = tm.extract_mesh(lambda x: sigma(x, lambda v: v.sum(-1)), bound=1.5, resolution=24, threshold=10.0)
    want = jm.extract_mesh(lambda x: sigma(x, lambda v: jnp.sum(v, -1)), bound=1.5, resolution=24, threshold=10.0)
    grid_t = tm.extract_fields(lambda x: sigma(x, lambda v: v.sum(-1)), 1.5, 24)
    grid_j = jm.extract_fields(lambda x: sigma(x, lambda v: jnp.sum(v, -1)), 1.5, 24)
    np.testing.assert_array_equal(grid_t, grid_j)
    assert len(got[1]) > 100 and np.abs(got[0]).max() <= 1.5
    np.testing.assert_array_equal(triangle_set(*got), triangle_set(*want))
