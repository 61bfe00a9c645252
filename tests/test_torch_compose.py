"""Composition and editing (render/compose.py, models/multiobject.py) on the
CPU: the port's functions held against the JAX package's on the same seeded
objects, rays, features, offsets and rotations."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_model import make_jax_params  # noqa: E402  (also starts torch's pool first)

from focnerf_tpu.models import multiobject as jmo  # noqa: E402
from focnerf_tpu.models import nerf as jnerf  # noqa: E402
from focnerf_tpu.render import compose as jcompose  # noqa: E402
from focnerf_tpu.render.renderer import render_rays as jrender_rays  # noqa: E402
from focnerf_tpu_torch import interop  # noqa: E402
from focnerf_tpu_torch.models import multiobject as tmo  # noqa: E402
from focnerf_tpu_torch.models import nerf as tnerf  # noqa: E402
from focnerf_tpu_torch.ops.composite import composite_rays_fused  # noqa: E402
from focnerf_tpu_torch.render import compose as tcompose  # noqa: E402
from focnerf_tpu_torch.render.renderer import render_rays as trender_rays  # noqa: E402

SMALL = dict(num_levels=4, log2_hashmap_size=12, hidden_dim=16, hidden_dim_color=16, bound=1.0)
GS = 32  # occupancy grid size of these tests

# fp32 on both sides: the same products summed in another order and libm vs
# XLA exp/pow, over up to 128 samples; no march flip is allowed at this size.
# bf16: both sides round the same operands; a 1-ulp fp32 difference may move
# a hidden unit to the neighbouring bf16 value.
TOL = {"float32": 1e-5, "bfloat16": 2e-3}


def configs(dtype="float32"):
    return (jnerf.NeRFConfig(**SMALL, compute_dtype=getattr(jnp, dtype)),
            tnerf.NeRFConfig(**SMALL, compute_dtype=getattr(torch, dtype)))


def object_params(jcfg, seed):
    """JAX params (numpy) of a visible object whose two finest levels are
    faint. With U(-1, 1) rows at the 2048-cell level, a 1-ulp move of a
    sample changes sigma by ~1e-4 relative; XLA contracts o + d * z into an
    FMA inside the JAX package's compiled fold, so JAX's own compose_rays
    then differs from its eager fold + composite by 5e-5. Faint fine levels
    keep that sensitivity below the fp32 tolerance; every level still
    contributes."""
    p = make_jax_params(jcfg, seed)
    p["sigma_net"][-1][:, 0] *= 4.0
    offsets = jcfg.grid_spec.offsets
    p["grid"][offsets[2]:] *= 0.02
    return p


def objects(jcfg, tcfg, seeds=(1, 2, 3)):
    """(JAX stacked params, the port's list) of distinct visible objects."""
    jps = [object_params(jcfg, s) for s in seeds]
    return (jcompose.stack_object_params([jax.tree.map(jnp.asarray, p) for p in jps]),
            tcompose.stack_object_params([interop.params_from_jax(p, tcfg, "cpu") for p in jps]))


def rays(n=96, seed=0):
    """Rays from a camera at distance 2.5 toward points around the origin."""
    rng = np.random.default_rng(seed)
    o = np.broadcast_to(np.array([0.3, -0.2, -2.5], np.float32), (n, 3)).copy()
    d = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def sphere_bits(centre, radius, cas=1, gs=GS, bound=1.0):
    """[CAS, gs^3] bool: cells whose centre lies within ``radius`` of ``centre``."""
    c = (np.arange(gs, dtype=np.float32) + 0.5) / gs * 2.0 - 1.0
    out = np.zeros((cas, gs**3), bool)
    for k in range(cas):
        s = min(2.0**k, bound)
        x, y, z = np.meshgrid(c * s, c * s, c * s, indexing="ij")
        r2 = (x - centre[0]) ** 2 + (y - centre[1]) ** 2 + (z - centre[2]) ** 2
        out[k] = (r2 < radius**2).reshape(-1)
    return out


FEATS = np.random.default_rng(4).normal(size=(3, 144)).astype(np.float32)
OFFSETS = np.array([[0.0, 0.0, 0.0], [0.25, -0.1, 0.05], [-0.15, 0.2, 0.0]], np.float32)
ROTATIONS = np.array([[0, 0, 0], [0, 0, 90], [0, 0, 0]], np.float32)


def assert_out_close(tout, jout, tol):
    for key in ("image", "depth", "alpha"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]), atol=tol, err_msg=key)


@pytest.mark.parametrize("offsets,grid_size", [
    # whole cells of cascade 0 (cell 2/32 = 0.0625) and of cascade 1 (0.125)
    (np.array([[0.125, -0.25, 0.0625]] * 3, np.float32), GS),
    # sub-cell, negative and positive: rounds to 0 or -1 cells
    (np.array([[0.02, -0.04, 0.05], [-0.03, 0.061, -0.0624], [0.0, 0.0, -0.02]], np.float32), GS),
    # exactly half a cell and 1.5 and 2.5 cells: round half to even
    (np.array([[0.03125, -0.03125, 0.09375], [-0.09375, 0.15625, -0.15625],
               [0.0625, 0.5, -0.1875]], np.float32), GS),
    # a shift past the grid on one axis empties that object
    (np.array([[3.0, 0.0, 0.0], [0.0, -0.7, 0.3], [0.0, 0.0, 0.0]], np.float32), GS),
    # the composition's grid size, bound 2
    (np.random.default_rng(1).uniform(-0.5, 0.5, (3, 3)).astype(np.float32), 128),
])
def test_union_occupancy_bits_bit_exact(offsets, grid_size):
    rng = np.random.default_rng(grid_size)
    bits = rng.uniform(size=(3, 2, grid_size**3)) < 0.3  # K = 3, 2 cascades
    bound = 2.0
    want = np.asarray(jcompose.union_occupancy_bits(jnp.asarray(bits), jnp.asarray(offsets), bound,
                                                    grid_size=grid_size))
    got = tcompose.union_occupancy_bits(torch.from_numpy(bits), offsets, bound, grid_size=grid_size)
    assert got.dtype == torch.bool and got.shape == (2, grid_size**3)
    np.testing.assert_array_equal(got.numpy(), want)
    got_none = tcompose.union_occupancy_bits(torch.from_numpy(bits), None, bound, grid_size=grid_size)
    np.testing.assert_array_equal(got_none.numpy(), bits.any(0))


def test_rotation_matrices_match_jax():
    degs = np.array([[0, 0, 90], [30, -45, 10], [90, 90, 90], [0, 0, 0], [-170, 12.5, 200]], np.float32)
    want = np.asarray(jcompose.rotation_matrices(degs))
    got = tcompose.rotation_matrices(degs)
    assert got.dtype == torch.float32 and got.shape == (5, 3, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-7, rtol=0)


def _compose_both(path, jsp, tsp, jcfg, tcfg, feats, offsets, rots, bits=None):
    o, d = rays()
    kw = dict(bg_color=0.0, min_near=0.2)
    if path == "uniform":
        j = jcompose.compose_rays(jsp, jcfg, jnp.asarray(o), jnp.asarray(d),
                                  None if feats is None else jnp.asarray(feats),
                                  None if offsets is None else jnp.asarray(offsets),
                                  None if rots is None else jnp.asarray(rots), num_steps=64, **kw)
        t = tcompose.compose_rays(tsp, tcfg, torch.from_numpy(o), torch.from_numpy(d), feats,
                                  offsets, rots, num_steps=64, **kw)
    else:
        kw.update(dt_gamma=1 / 128, max_steps=512, slab=64, grid_size=GS)
        j = jcompose.compose_rays_occupancy(jsp, jcfg, jnp.asarray(o), jnp.asarray(d), jnp.asarray(bits),
                                            None if feats is None else jnp.asarray(feats),
                                            None if offsets is None else jnp.asarray(offsets),
                                            None if rots is None else jnp.asarray(rots), **kw)
        t = tcompose.compose_rays_occupancy(tsp, tcfg, torch.from_numpy(o), torch.from_numpy(d),
                                            torch.from_numpy(bits), feats, offsets, rots, **kw)
    return t, j


def _union(offsets, gs=GS):
    per_obj = np.stack([sphere_bits((0.0, 0.0, 0.0), 0.7, gs=gs), sphere_bits((0.3, 0.1, 0.0), 0.4, gs=gs),
                        sphere_bits((-0.2, -0.3, 0.1), 0.5, gs=gs)])
    return np.array(jcompose.union_occupancy_bits(jnp.asarray(per_obj),
                                                    None if offsets is None else jnp.asarray(offsets),
                                                    1.0, grid_size=gs))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path,edit", [
    ("uniform", "none"), ("uniform", "offsets"), ("uniform", "offsets+rotation"),
    ("occupancy", "none"), ("occupancy", "offsets"), ("occupancy", "offsets+rotation"),
])
def test_compose_rays_match_jax(path, edit, dtype):
    """K = 3 distinct objects with their own features; the edits translate
    two of them and rotate one by 90 degrees about z."""
    jcfg, tcfg = configs(dtype)
    jsp, tsp = objects(jcfg, tcfg)
    offsets = None if edit == "none" else OFFSETS
    rots = np.array(jcompose.rotation_matrices(ROTATIONS)) if "rotation" in edit else None
    composite_rays_fused.launches = 0
    t, j = _compose_both(path, jsp, tsp, jcfg, tcfg, FEATS, offsets, rots, bits=_union(offsets))
    assert composite_rays_fused.launches == 0  # CPU tensors: the plain compositor
    alpha = np.asarray(j["alpha"])
    assert 0.1 < alpha.mean() < 0.95 and alpha.max() > 0.5  # objects, not an empty view
    assert_out_close(t, j, TOL[dtype])


def test_edits_change_the_composition():
    """An offset or a rotation moves what the rays see (neither is a no-op)."""
    jcfg, tcfg = configs()
    _, tsp = objects(jcfg, tcfg)
    o, d = (torch.from_numpy(a) for a in rays())
    rots = tcompose.rotation_matrices(ROTATIONS)
    base = tcompose.compose_rays(tsp, tcfg, o, d, FEATS, num_steps=64)["image"]
    moved = tcompose.compose_rays(tsp, tcfg, o, d, FEATS, OFFSETS, num_steps=64)["image"]
    turned = tcompose.compose_rays(tsp, tcfg, o, d, FEATS, None, rots, num_steps=64)["image"]
    # far above fp32 noise (~1e-7 here)
    assert (moved - base).abs().max() > 1e-3 and (turned - base).abs().max() > 1e-3


@pytest.mark.parametrize("path", ["uniform", "occupancy"])
def test_max_density_selection(path):
    """tests/test_compose_utils.py::test_max_density_selection on both paths:
    the denser object's colour wins, so composing [thin, dense] renders the
    dense object alone; and the port agrees with JAX on the same case."""
    jcfg = jnerf.NeRFConfig(**SMALL, use_objfeat=False, compute_dtype=jnp.float32)
    tcfg = tnerf.NeRFConfig(**SMALL, use_objfeat=False, compute_dtype=torch.float32)
    dense, thin = make_jax_params(jcfg, 1), make_jax_params(jcfg, 2)
    dense["sigma_net"][-1][:, 0] = 5.0
    thin["sigma_net"][-1][:, 0] = -5.0
    jsp = jcompose.stack_object_params([jax.tree.map(jnp.asarray, p) for p in (thin, dense)])
    tsp = [interop.params_from_jax(p, tcfg, "cpu") for p in (thin, dense)]
    bits = sphere_bits((0.0, 0.0, 0.0), 0.9)
    t, j = _compose_both(path, jsp, tsp, jcfg, tcfg, None, None, None, bits=bits)
    assert_out_close(t, j, TOL["float32"])
    o, d = (torch.from_numpy(a) for a in rays())
    if path == "uniform":
        solo = trender_rays(tsp[1], tcfg, o, d, num_steps=64, bg_color=0.0)
        jsolo = jrender_rays(jax.tree.map(jnp.asarray, dense), jcfg, jnp.asarray(o.numpy()),
                             jnp.asarray(d.numpy()), num_steps=64, bg_color=0.0)
        np.testing.assert_allclose(np.asarray(jsolo["image"]), solo["image"].numpy(), atol=1e-5)
        np.testing.assert_allclose(t["image"].numpy(), solo["image"].numpy(), atol=1e-4)
    assert float(t["alpha"].mean()) > 0.1


@pytest.mark.parametrize("path", ["uniform", "occupancy"])
def test_duplicate_objects_compose_as_one(path):
    """Objects [A, A] give exactly what [A] gives: on equal sigma the first
    copy keeps the sample (strict >), so the fused fields are the same bits."""
    jcfg, tcfg = configs()
    _, tsp = objects(jcfg, tcfg, seeds=(1,))
    a = tsp[0]
    o, d = (torch.from_numpy(x) for x in rays())
    feat = torch.from_numpy(FEATS[:1])
    bits1 = torch.from_numpy(sphere_bits((0.0, 0.0, 0.0), 0.7))[None]
    if path == "uniform":
        one = tcompose.compose_rays([a], tcfg, o, d, feat, num_steps=64)
        two = tcompose.compose_rays([a, a], tcfg, o, d, feat.repeat(2, 1), num_steps=64)
    else:
        kw = dict(dt_gamma=1 / 128, max_steps=512, slab=64, grid_size=GS)
        one = tcompose.compose_rays_occupancy(
            [a], tcfg, o, d, tcompose.union_occupancy_bits(bits1, None, 1.0, GS), feat, **kw)
        two = tcompose.compose_rays_occupancy(
            [a, a], tcfg, o, d, tcompose.union_occupancy_bits(bits1.repeat(2, 1, 1), np.zeros((2, 3)),
                                                              1.0, GS), feat.repeat(2, 1), **kw)
    for key in ("image", "depth", "alpha"):
        assert torch.equal(one[key], two[key]), key
    assert float(one["alpha"].mean()) > 0.1


@pytest.mark.parametrize("fn", ["density", "field"])
def test_multiobject_fields_match_jax(fn):
    jcfg, tcfg = configs()
    jsp, tsp = objects(jcfg, tcfg)
    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, (64, 8, 3)).astype(np.float32)
    d = rng.normal(size=(64, 8, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if fn == "density":
        want = jmo.mo_density_fn(jsp, jcfg, jnp.asarray(x))
        got = tmo.mo_density_fn(tsp, tcfg, torch.from_numpy(x))
    else:
        want = jmo.mo_field_fn(jsp, jcfg, jnp.asarray(x), jnp.asarray(d), jnp.asarray(FEATS))
        got = tmo.mo_field_fn(tsp, tcfg, torch.from_numpy(x), torch.from_numpy(d), torch.from_numpy(FEATS))
    # the per-point argmax must pick the same object everywhere
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=2e-5, atol=2e-6)
    # every object wins somewhere: the fold is not a pass-through of one
    sig = torch.stack([tnerf.density_fn(p, tcfg, torch.from_numpy(x))[0] for p in tsp])
    assert len(torch.unique(sig.argmax(0))) == 3


def test_compose_image_matches_jax_and_pads():
    """The chunk loop: 15x13 rays in chunks of 64 (a padded last chunk),
    occupancy path with offsets; RGBA and depth against JAX's."""
    jcfg, tcfg = configs()
    jsp, tsp = objects(jcfg, tcfg)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.1, 0.0, 2.6]  # ngp camera looking down -z at the objects
    pose[:3, :3] = np.diag([1.0, -1.0, -1.0])
    intr = np.array([16.0, 16.0, 7.5, 6.5], np.float32)
    bits = _union(OFFSETS, gs=128)  # compose_image marches the 128^3 grid
    kw = dict(max_ray_batch=64, bg_color=0.0, dt_gamma=1 / 128, max_steps=512, slab=64)
    jrgba, jdepth = jcompose.compose_image(jsp, jcfg, jnp.asarray(pose), intr, 13, 15, jnp.asarray(FEATS),
                                           jnp.asarray(OFFSETS), occ_bits=jnp.asarray(bits), **kw)
    composite_rays_fused.launches = 0
    trgba, tdepth = tcompose.compose_image(tsp, tcfg, pose, intr, 13, 15, FEATS, OFFSETS,
                                           occ_bits=torch.from_numpy(bits), **kw)
    assert composite_rays_fused.launches == 0
    assert trgba.shape == (13, 15, 4) and tdepth.shape == (13, 15)
    assert float(trgba[..., 3].mean()) > 0.1
    np.testing.assert_allclose(trgba.numpy(), np.asarray(jrgba), atol=TOL["float32"])
    np.testing.assert_allclose(tdepth.numpy(), np.asarray(jdepth), atol=TOL["float32"])


def test_compose_composites_through_the_fused_wrapper(monkeypatch):
    """Both paths composite every chunk through ``composite_rays_fused`` (the
    kernel's wrapper on CUDA tensors), never the plain compositor itself."""
    assert not hasattr(tcompose, "composite_rays")
    calls = []

    def counted(*args, **kwargs):
        calls.append((tuple(args[0].shape), kwargs["T_thresh"]))
        return composite_rays_fused(*args, **kwargs)

    monkeypatch.setattr(tcompose, "composite_rays_fused", counted)
    jcfg, tcfg = configs()
    _, tsp = objects(jcfg, tcfg)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.0, 0.0, 2.6]
    pose[:3, :3] = np.diag([1.0, -1.0, -1.0])
    intr = np.array([16.0, 16.0, 8.0, 8.0], np.float32)
    tcompose.compose_image(tsp, tcfg, pose, intr, 16, 16, FEATS, num_steps=32, max_ray_batch=100)
    tcompose.compose_image(tsp, tcfg, pose, intr, 16, 16, FEATS, max_ray_batch=100, slab=64,
                           occ_bits=torch.from_numpy(_union(None, gs=128)), dt_gamma=1 / 128)
    assert calls == [((100, 32), 0.0)] * 3 + [((100, 64), 1e-4)] * 3
