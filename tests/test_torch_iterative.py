"""The iterative eval renderer (render/iterative.py) and its compositor
(``composite_rays_resume``) held against the JAX package on the CPU: the
same numpy inputs and the same weights (``interop.params_from_jax``) go
through ``focnerf_tpu.render.iterative`` and the port; the trainer's
``iter`` evaluation against JAX's ``render_image_iterative`` on one state.

Tolerances: everything here is fp32 on both sides, over the same sample
lattice, so the ports differ only in the order of fp32 sums (cumsum and
reductions, libm vs XLA exp): 1e-5 absolute.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from helpers import make_synthetic_scene  # noqa: E402
from test_torch_model import SMALL, start_torch_threads  # noqa: E402
from test_torch_render import sphere_density_grid, visible_params  # noqa: E402

from focnerf_tpu.models import nerf as jnerf  # noqa: E402
from focnerf_tpu.ops.occupancy import occupancy_skip_field as jskip_field  # noqa: E402
from focnerf_tpu.render import iterative as jit_  # noqa: E402
from focnerf_tpu_torch import interop  # noqa: E402
from focnerf_tpu_torch.models import nerf as tnerf  # noqa: E402
from focnerf_tpu_torch.ops.composite import composite_rays_resume  # noqa: E402
from focnerf_tpu_torch.ops.occupancy import occupancy_skip_field as tskip_field  # noqa: E402
from focnerf_tpu_torch.render import iterative as tit  # noqa: E402

start_torch_threads()

# the JAX package's own iterative-render setup (tests/test_iterative_render.py)
CFG = dict(num_levels=4, base_resolution=4, log2_hashmap_size=12, use_objfeat=False)
GS = 32
KW = dict(dt_gamma=0.0, max_steps=256, bg_color=1.0, grid_size=GS, sub_slab=8, bucket_base=16)
ATOL = 1e-5  # fp32, the same lattice, sums in another order


@pytest.fixture(scope="module")
def sphere():
    """(JAX params, port params, JAX skip field, port skip field, rays_o,
    rays_d): a sphere of radius 0.6 in a 32^3 grid, 64 rays from z = -2.5."""
    jcfg = jnerf.NeRFConfig(**CFG, compute_dtype=jnp.float32)
    tcfg = tnerf.NeRFConfig(**CFG, compute_dtype=torch.float32)
    jp = jax.tree.map(np.asarray, jnerf.init_nerf_params(jax.random.key(0), jcfg))
    c = (np.arange(GS) + 0.5) / GS * 2 - 1
    X, Y, Z = np.meshgrid(c, c, c, indexing="ij")
    occ = (X**2 + Y**2 + Z**2 < 0.6**2).reshape(1, -1)
    rng = np.random.default_rng(0)
    o = np.zeros((64, 3), np.float32)
    o[:, 2] = -2.5
    d = rng.normal(0, 0.12, (64, 3)).astype(np.float32)
    d[:, 2] += 1
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jax.tree.map(jnp.asarray, jp),
                tp=interop.params_from_jax(jp, tcfg, "cpu"),
                jskip=jskip_field(jnp.asarray(occ), GS), tskip=tskip_field(torch.from_numpy(occ), GS),
                o=o, d=d)


def _render(s, o, d, **kw):
    """(JAX's render, the port's render, the port's rounds)."""
    j = jit_.render_rays_iterative(s["jp"], s["jcfg"], jnp.asarray(o), jnp.asarray(d), s["jskip"],
                                   **KW, **kw)
    tit.render_rays_iterative.rounds = 0
    t = tit.render_rays_iterative(s["tp"], s["tcfg"], torch.from_numpy(o), torch.from_numpy(d),
                                  s["tskip"], **KW, **kw)
    return j, t, tit.render_rays_iterative.rounds


@pytest.mark.parametrize("device_loop", [False, True], ids=["host_ladder", "drain"])
def test_render_rays_iterative_matches_jax(sphere, device_loop):
    j, t, rounds = _render(sphere, sphere["o"], sphere["d"], device_loop=device_loop)
    for key in ("image", "weights_sum", "depth"):
        np.testing.assert_allclose(t[key].numpy(), np.asarray(j[key]), atol=ATOL, err_msg=key)
    assert 0.1 < float(t["weights_sum"].mean()) < 0.9  # some rays hit the sphere, some miss
    assert rounds > 1


def test_background_rays_are_white_after_one_round(sphere):
    """Rays that cross the bound box but pass the sphere march through empty
    space, fill no sub-slab and leave the worklist after the first round."""
    d = np.tile(np.array([[0.3, 0.3, 1.0]], np.float32), (16, 1))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    j, t, rounds = _render(sphere, sphere["o"][:16], d)
    assert rounds == 1
    np.testing.assert_allclose(t["image"].numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(t["image"].numpy(), np.asarray(j["image"]), atol=ATOL)


def test_render_image_iterative_matches_jax(sphere):
    from focnerf_tpu.core.camera import rand_poses

    pose = rand_poses(np.random.default_rng(0), 1, radius=2.5)[0].astype(np.float32)
    intr = (16.0, 16.0, 8.0, 8.0)
    kw = dict(dt_gamma=0.0, max_steps=256, grid_size=GS, bucket_base=64)
    jimg, jdepth = jit_.render_image_iterative(sphere["jp"], sphere["jcfg"], jnp.asarray(pose), intr,
                                               16, 16, occ_skip=sphere["jskip"], **kw)
    timg, tdepth = tit.render_image_iterative(sphere["tp"], sphere["tcfg"], pose, intr, 16, 16,
                                              occ_skip=sphere["tskip"], **kw)
    assert timg.shape == (16, 16, 3) and tdepth.shape == (16, 16)
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), atol=ATOL)
    np.testing.assert_allclose(tdepth.numpy(), np.asarray(jdepth), atol=ATOL)


def _resume_inputs(n=64, t=24, seed=0):
    """A composite row of each of n rays with inf spikes (trunc_exp's fp32
    overflow) at the first, a middle and the last sample of some rays."""
    rng = np.random.default_rng(seed)
    sig = rng.uniform(0, 20, (n, t)).astype(np.float32)
    sig[::3] *= 1e-3  # thin rays keep their transmittance to the row's end
    sig[1, 0] = sig[4, 7] = sig[7, t - 1] = np.inf
    rgb = rng.uniform(0, 1, (n, t, 3)).astype(np.float32)
    dts = rng.uniform(0.003, 0.05, (n, t)).astype(np.float32)
    ts = (2.0 + np.cumsum(dts, -1)).astype(np.float32)
    return sig, rgb, dts, ts


def _jax_round(sig, rgb, dts, ts, od0, T_thresh):
    """focnerf_tpu/render/iterative.py:91-106, the round's compositing."""
    s = jnp.asarray(dts) * 1.0 * jnp.asarray(sig)
    excl = jnp.concatenate([jnp.zeros_like(s[..., :1]), jnp.cumsum(s[..., :-1], axis=-1)], -1)
    T_in = jnp.exp(-(jnp.asarray(od0)[:, None] + excl))
    w = (1.0 - jnp.exp(-s)) * T_in
    if T_thresh > 0.0:
        w = jnp.where(T_in >= T_thresh, w, 0.0)
    return (jnp.sum(w[..., None] * jnp.asarray(rgb), axis=-2), jnp.sum(w, axis=-1),
            jnp.sum(w * jnp.asarray(ts), axis=-1), jnp.asarray(od0) + jnp.sum(s, axis=-1))


@pytest.mark.parametrize("T_thresh", [0.0, 1e-4])
@pytest.mark.parametrize("od0_kind", ["zero", "random"])
def test_composite_resume_plain_matches_jax_round(od0_kind, T_thresh):
    sig, rgb, dts, ts = _resume_inputs()
    od0 = np.zeros(sig.shape[0], np.float32)
    if od0_kind == "random":
        od0 = np.random.default_rng(1).uniform(0, 6, sig.shape[0]).astype(np.float32)
    want = _jax_round(sig, rgb, dts, ts, od0, T_thresh)
    composite_rays_resume.launches = 0
    got = composite_rays_resume(*map(torch.from_numpy, (sig, rgb, dts, ts, od0)), T_thresh=T_thresh)
    assert composite_rays_resume.launches == 0  # CPU tensors never launch
    for name, a, b in zip(("rgb", "weights_sum", "depth", "od"), got, want):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert name == "od" or torch.isfinite(a).all(), name  # od is inf behind a spike
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("T_thresh", [0.0, 1e-4])
def test_composite_resume_two_segments(T_thresh):
    """Compositing [a|b] at once equals a, then b at od0 = od_a, summed."""
    sig, rgb, dts, ts = map(torch.from_numpy, _resume_inputs())
    od0 = torch.zeros(sig.shape[0])
    whole = composite_rays_resume(sig, rgb, dts, ts, od0, T_thresh=T_thresh)
    k = 10
    a = composite_rays_resume(sig[:, :k], rgb[:, :k], dts[:, :k], ts[:, :k], od0, T_thresh=T_thresh)
    b = composite_rays_resume(sig[:, k:], rgb[:, k:], dts[:, k:], ts[:, k:], a[3], T_thresh=T_thresh)
    for name, w, x, y in zip(("rgb", "weights_sum", "depth"), whole[:3], a[:3], b[:3]):
        np.testing.assert_allclose((x + y).numpy(), w.numpy(), atol=ATOL, err_msg=name)
    np.testing.assert_allclose(b[3].numpy(), whole[3].numpy(), rtol=1e-6)  # inf where spiked


def test_trainer_evaluate_iter_matches_jax(tmp_path):
    """``Trainer.evaluate`` with eval_renderer "iter" renders each val view
    as JAX's ``render_image_iterative`` does on the same params and grid."""
    from focnerf_tpu.train.meters import psnr as jpsnr
    from focnerf_tpu_torch.data.png import read_image
    from focnerf_tpu_torch.data.provider import DatasetOptions, NeRFDataset
    from focnerf_tpu_torch.ops.occupancy import OccupancyState
    from focnerf_tpu_torch.train.state import TrainState
    from focnerf_tpu_torch.train.trainer import Trainer

    jcfg = jnerf.NeRFConfig(**dict(SMALL, use_objfeat=False), compute_dtype=jnp.float32)
    tcfg = tnerf.NeRFConfig(**dict(SMALL, use_objfeat=False), compute_dtype=torch.float32)
    jp = visible_params(jcfg)
    scene = make_synthetic_scene(str(tmp_path / "scene"), n_train=1, n_val=1)
    ds = NeRFDataset(DatasetOptions(path=scene, scale=1.0), split="val", device="cpu")
    grid = torch.from_numpy(sphere_density_grid(1.0))

    tr = Trainer("ngp", tcfg, workspace=str(tmp_path / "ws"), use_occupancy=True,
                 eval_renderer="iter", use_checkpoint="scratch", device="cpu")
    tr.state = TrainState(interop.params_from_jax(jp, tcfg, "cpu"), lr=1e-2, iters=1)
    tr.occupancy = OccupancyState(grid, grid.mean(), torch.tensor(1, dtype=torch.int32))
    tit.render_rays_iterative.rounds = 0
    results = tr.evaluate(ds, save_images=True)
    assert tit.render_rays_iterative.rounds > 0  # the iterative renderer drew the view

    # the port's skip field equals JAX's (test_torch_train_ops); reusing it saves
    # the JAX build of a 128^3 field
    skip = tskip_field(torch.from_numpy(sphere_density_grid(1.0) > tr.density_thresh))
    jimg, _ = jit_.render_image_iterative(
        jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(np.asarray(ds.poses[0])),
        ds.intrinsics, ds.H, ds.W, occ_skip=jnp.asarray(skip.numpy()), dt_gamma=tr.dt_gamma,
        max_steps=tr.max_steps, min_near=tr.min_near, bg_color=1.0,
    )
    jimg = np.asarray(jimg)
    assert 0.05 < float((1.0 - jimg).mean()) < 0.95  # a visible object, not blank
    gt = ds.eval_view(0)["pixels"].reshape(ds.H, ds.W, -1).numpy()
    gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:])
    want = float(jpsnr(jnp.clip(jnp.asarray(jimg), 0.0, 1.0), jnp.asarray(gt)))
    np.testing.assert_allclose(results["PSNR"], want, rtol=1e-5)
    png = read_image(os.path.join(str(tmp_path / "ws"), "validation", "ngp_val_0000_0000.png"))
    # PNGs quantize to 1/255: a value within ATOL of a rounding edge may land
    # one level apart
    assert np.abs(png.astype(int) - (np.clip(jimg, 0, 1) * 255).astype(np.uint8)).max() <= 1
