"""The D-NeRF renderers and the time grid (render/dnerf_renderer.py) held
against the JAX package's on the CPU, with the same params and the same
draws on both sides: uniform samples with their jitter, the time slot's
march (ladder and skip walk) with its start jitter, a full image on both
paths, one slot refresh per call and the bitfield of a time."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_compose import rays, sphere_bits  # noqa: E402
from test_torch_dnerf import configs, make_dnerf_params  # noqa: E402  (also starts torch's pool first)

from focnerf_tpu.ops.occupancy import occupancy_skip_field as jskip  # noqa: E402
from focnerf_tpu.render import dnerf_renderer as jdr  # noqa: E402
from focnerf_tpu_torch import interop  # noqa: E402
from focnerf_tpu_torch.ops.composite import composite_rays_fused  # noqa: E402
from focnerf_tpu_torch.ops.occupancy import occupancy_skip_field as tskip  # noqa: E402
from focnerf_tpu_torch.render import dnerf_renderer as tdr  # noqa: E402

GS, N = 32, 64
# fp32: the same products summed in another order, over up to 64 samples a
# ray (as test_torch_compose.py's TOL); no march flip at this size. The
# hyper variant's lifted coordinates come out of an MLP with 1-ulp
# differences, which the finest level's scale (2027) moves its weights by
# ~1.2e-4 (faint there, x0.02): measured 1.7e-5 on one ray's depth.
TOL = 1e-5
HYPER_TOL = 5e-5


def _pair(variant, seed=0):
    jcfg, tcfg = configs(variant)
    jp = make_dnerf_params(jcfg, seed)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, jp), interop.dnerf_params_from_jax(jp, tcfg, "cpu")


def _close(tout, jout, tol=TOL, keys=("image", "depth", "weights_sum")):
    for k in keys:
        np.testing.assert_allclose(tout[k].detach().numpy(), np.asarray(jout[k]), rtol=0, atol=tol, err_msg=k)


@pytest.mark.parametrize("variant", ["deform", "basis", "hyper"])
def test_uniform_render_matches_jax(variant):
    jcfg, tcfg, jp, tp = _pair(variant)
    o, d = rays(N)
    key, t, steps = jax.random.key(7), 0.3, 48
    bg = np.random.default_rng(1).uniform(size=(N, 3)).astype(np.float32)
    jout = jdr.render_rays_dnerf(jp, jcfg, jnp.asarray(o), jnp.asarray(d), jnp.float32(t), num_steps=steps,
                                 rng=key, perturb=True, bg_color=jnp.asarray(bg))
    z_noise = torch.from_numpy(np.array(jax.random.uniform(key, (N, steps))))  # the JAX step's draw
    tout = tdr.render_rays_dnerf(tp, tcfg, torch.from_numpy(o), torch.from_numpy(d), torch.tensor(t),
                                 num_steps=steps, perturb=True, z_noise=z_noise, bg_color=torch.from_numpy(bg))
    _close(tout, jout, HYPER_TOL if variant == "hyper" else TOL)
    assert float(jout["weights_sum"].max()) > 0.5  # the object is visible
    assert ("deform_mean" in tout) == ("deform_mean" in jout) == (variant == "deform")
    if variant == "deform":
        np.testing.assert_allclose(float(tout["deform_mean"]), float(jout["deform_mean"]), rtol=1e-5)


@pytest.mark.parametrize("skip", [False, True], ids=["ladder", "skip"])
@pytest.mark.parametrize("variant", ["deform", "hyper"])
def test_occupancy_render_matches_jax(variant, skip):
    jcfg, tcfg, jp, tp = _pair(variant, seed=1)
    o, d = rays(N, seed=2)
    bits = sphere_bits((0.1, 0.0, 0.0), 0.6)
    occ_j = jskip(jnp.asarray(bits), grid_size=GS) if skip else jnp.asarray(bits)
    occ_t = tskip(torch.from_numpy(bits), grid_size=GS) if skip else torch.from_numpy(bits)
    key, t = jax.random.key(3), 0.8
    kw = dict(dt_gamma=1 / 128, max_steps=256, slab=32, grid_size=GS, bg_color=1.0)
    jout = jdr.render_rays_dnerf_occupancy(jp, jcfg, jnp.asarray(o), jnp.asarray(d), jnp.float32(t), occ_j,
                                           rng=key, perturb=True, occ_skip=occ_j if skip else None, **kw)
    noise = torch.from_numpy(np.array(jax.random.uniform(key, (N,))))  # the march's draw
    tout = tdr.render_rays_dnerf_occupancy(tp, tcfg, torch.from_numpy(o), torch.from_numpy(d), t, occ_t,
                                           perturb=True, noise=noise, occ_skip=occ_t if skip else None, **kw)
    np.testing.assert_array_equal(tout["n_samples"].numpy(), np.asarray(jout["n_samples"]))
    assert float(np.asarray(jout["n_samples"]).mean()) > 4
    _close(tout, jout, HYPER_TOL if variant == "hyper" else TOL)


def test_render_image_matches_jax_and_uses_the_fused_compositor():
    jcfg, tcfg, jp, tp = _pair("deform", seed=2)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.2, -0.1, 2.6]
    intr, H, W = (20.0, 20.0, 8.0, 8.0), 16, 16
    bits = sphere_bits((0.0, 0.0, 0.0), 0.7, gs=128)  # render_image_dnerf marches a 128^3 grid
    before = composite_rays_fused.launches
    for occ in (None, bits):
        kw = dict(num_steps=32, max_ray_batch=100, slab=32, max_steps=256, dt_gamma=1 / 128)
        ji, jd = jdr.render_image_dnerf(jp, jcfg, jnp.asarray(pose), intr, H, W, 0.5,
                                        occ_bits=None if occ is None else jnp.asarray(occ), **kw)
        ti, td = tdr.render_image_dnerf(tp, tcfg, pose, intr, H, W, 0.5,
                                        occ_bits=None if occ is None else torch.from_numpy(occ), **kw)
        assert ti.shape == (H, W, 3) and td.shape == (H, W)
        np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=0, atol=TOL)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=TOL)
    assert composite_rays_fused.launches == before  # the CPU takes the plain version


def test_time_grid_refresh_and_bitfield_match_jax():
    """Every slot refreshed once (with the JAX call's own jitter draws), a
    second round over the first slots (the decay), then the bitfield of
    times in each slot; the port refreshes in place, at a larger chunk."""
    jcfg, tcfg, jp, tp = _pair("deform", seed=3)
    slots, thresh = 4, 5.0
    jocc = jdr.init_time_occupancy(1.0, time_slots=slots, grid_size=GS)
    tocc = tdr.init_time_occupancy(1.0, "cpu", time_slots=slots, grid_size=GS)
    from focnerf_tpu.models.dnerf import dnerf_density as jdens
    from focnerf_tpu_torch.models.dnerf import dnerf_density as tdens

    for i, slot in enumerate([0, 1, 2, 3, 0, 1]):
        key = jax.random.key(10 + i)
        jocc = jdr.update_time_occupancy(jocc, lambda x, t: jdens(jp, jcfg, x, t)[0], key, bound=1.0,
                                         time_slot=jnp.int32(slot), grid_size=GS, chunk=GS**3 // 4)
        jitter = np.stack([np.array(jax.random.uniform(jax.random.fold_in(key, c), (GS**3, 3)))
                           for c in range(tocc.density_grid.shape[1])])
        tocc = tdr.update_time_occupancy(tocc, lambda x, t: tdens(tp, tcfg, x, t)[0],
                                         {"jitter": torch.from_numpy(jitter)}, bound=1.0, time_slot=slot,
                                         grid_size=GS)
    want = np.asarray(jocc.density_grid)
    got = tocc.density_grid.numpy()
    # fp32 sigma (an exp) of the same points: relative to each cell's value
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
    assert int(tocc.iter_density) == int(jocc.iter_density) == 6
    np.testing.assert_allclose(float(tocc.mean_density), float(jocc.mean_density), rtol=2e-5)
    assert (want > 0).mean(axis=(1, 2)).min() > 0  # every slot holds density
    for t in (0.0, 0.2, 0.26, 0.5, 0.74, 0.99, 1.0):
        jb = np.asarray(jdr.time_occupancy_bitfield(jocc, jnp.float32(t), thresh))
        tb = tdr.time_occupancy_bitfield(tocc, torch.tensor(t), thresh).numpy()
        # cells within the fp32 tolerance of the threshold may flip
        near = np.abs(want[min(int(t * slots), slots - 1)] - min(float(jocc.mean_density), thresh)) < 1e-4
        assert np.array_equal(tb[~near], jb[~near]) and 0 < tb.mean() < 1
