"""Training without the occupancy grid, and the sampling extras, on the CPU
against the JAX package:

  - ``sample_ray_indices``' patch and error-map modes, and the provider's
    batch with them, on JAX's draws; ``update_error_map`` and the trainer's
    per-view update;
  - ``sample_pdf`` (random and midpoint quantiles, rays that miss the box);
  - ``render_image``'s uniform route with importance upsampling;
  - one uniform train step (upsampling, jitter, TV, alpha and mask terms):
    loss, gradients and ``per_ray_error``, from JAX's draws;
  - ``main_nerf`` without ``-O`` (upsampling, error map, TV) and with
    ``-O2`` (patches), end to end, each ending with its mesh.
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
from test_torch_model import SMALL, make_jax_params, start_torch_threads  # noqa: E402
from test_torch_train import _batch, _leaves  # noqa: E402

from focnerf_tpu.core.rays import sample_ray_indices as jsample  # noqa: E402
from focnerf_tpu.models import nerf as jnerf  # noqa: E402
from focnerf_tpu.render import renderer as jrenderer  # noqa: E402
from focnerf_tpu.train import state as jstate  # noqa: E402
from focnerf_tpu.train import steps as jsteps  # noqa: E402
from focnerf_tpu_torch import interop  # noqa: E402
from focnerf_tpu_torch.core.rays import sample_ray_indices  # noqa: E402
from focnerf_tpu_torch.models import nerf as tnerf  # noqa: E402
from focnerf_tpu_torch.render import renderer as trenderer  # noqa: E402
from focnerf_tpu_torch.train import steps as tsteps  # noqa: E402
from focnerf_tpu_torch.train.state import clone_params, param_leaves  # noqa: E402

start_torch_threads()

to_t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_synthetic_scene(str(tmp_path_factory.mktemp("uniform") / "scene"), n_train=3, n_val=1)


def _index_draws(key, H, W, n, patch_size=1, error_map=False):
    """The draws JAX's ``sample_ray_indices`` makes from ``key``."""
    if patch_size > 1:
        k1, k2 = jax.random.split(key)
        m = n // patch_size**2
        return {"ix": to_t(jax.random.randint(k1, (m,), 0, H - patch_size)).long(),
                "iy": to_t(jax.random.randint(k2, (m,), 0, W - patch_size)).long()}
    k1, k2, k3 = jax.random.split(key, 3)
    return {"gumbel_u": to_t(jax.random.uniform(k1, (128 * 128,))), "jx": to_t(jax.random.uniform(k2, (n,))),
            "jy": to_t(jax.random.uniform(k3, (n,)))}


@pytest.mark.parametrize("H,W", [(32, 48), (200, 136)])
def test_sample_ray_indices_patch_and_error_map_match_jax(H, W):
    """Integer indices: equal to the element."""
    key = jax.random.key(5)
    for p in (2, 4):
        want, none = jsample(key, H, W, 256, patch_size=p)
        got, got_none = sample_ray_indices(H, W, 256, _index_draws(key, H, W, 256, patch_size=p), patch_size=p)
        assert none is None and got_none is None and got.shape == (256 // p**2 * p**2,)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    em = np.random.default_rng(0).gamma(0.5, 0.2, 128 * 128).astype(np.float32)
    want, want_c = jsample(key, H, W, 512, error_map=jnp.asarray(em))
    got, got_c = sample_ray_indices(H, W, 512, _index_draws(key, H, W, 512, error_map=True),
                                    error_map=torch.from_numpy(em))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(set(got_c.tolist())) == 512  # without replacement


@pytest.mark.parametrize("mode", ["patch", "error_map"])
def test_provider_batch_matches_jax(scene, mode):
    """The port's ``train_batch`` on JAX's view and index draws gives JAX's
    batch: rays fp32 within 1e-6 (the same rotation summed in another
    order), pixels and cells equal."""
    from focnerf_tpu.data.provider import DatasetOptions as JOpts
    from focnerf_tpu.data.provider import NeRFDataset as JDataset
    from focnerf_tpu_torch.data.provider import DatasetOptions, NeRFDataset

    kw = dict(path=scene, scale=1.0, num_rays=64, **({"patch_size": 4} if mode == "patch" else {"error_map": True}))
    jds = JDataset(JOpts(**kw), split="train")
    tds = NeRFDataset(DatasetOptions(**kw), split="train", device="cpu")
    if mode == "error_map":
        assert tds.error_map.shape == (3, 128 * 128) and bool((tds.error_map == 0.1).all())
        em = np.random.default_rng(1).uniform(0.01, 1, (3, 128 * 128)).astype(np.float32)
        jds.error_map, tds.error_map = jnp.asarray(em), torch.from_numpy(em)
    else:
        assert tds.error_map is None
    key = jax.random.key(2)
    want = jds.train_batch(key)
    draws = _index_draws(jax.random.split(key)[0], jds.H, jds.W, 64, patch_size=kw.get("patch_size", 1),
                         error_map=mode == "error_map")
    draws["view"] = to_t(jax.random.randint(jax.random.fold_in(key, 17), (), 0, 3)).long().reshape(1)
    got = tds.train_batch(None, draws=draws)
    assert set(got) == set(want)
    for k in ("rays_o", "rays_d", "pixels"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6, err_msg=k)
    assert int(got["view"]) == int(want["view"])
    if mode == "error_map":
        np.testing.assert_array_equal(got["inds_coarse"].numpy(), np.asarray(want["inds_coarse"]))


def test_update_error_map_matches_jax():
    """fp32, the same two products and sum: equal to the bit against the
    eager update; within 1 ulp against the trainer's jitted step, where XLA
    fuses the sum into an FMA."""
    from focnerf_tpu.train.trainer import _error_map_step as jstep
    from focnerf_tpu_torch.train.trainer import Trainer

    rng = np.random.default_rng(0)
    em = rng.uniform(0, 1, (3, 128 * 128)).astype(np.float32)
    inds = rng.choice(128 * 128, 300, replace=False)
    err = rng.uniform(0, 1, 300).astype(np.float32)
    want = np.asarray(jsteps.update_error_map(jnp.asarray(em[1]), jnp.asarray(inds), jnp.asarray(err)))
    got = tsteps.update_error_map(torch.from_numpy(em[1]), torch.from_numpy(inds), torch.from_numpy(err))
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jstep(jnp.asarray(em), jnp.int32(1), jnp.asarray(inds), jnp.asarray(err)))
    ds = type("DS", (), {"error_map": torch.from_numpy(em.copy())})()
    Trainer._error_map_step(ds, {"view": torch.tensor(1), "inds_coarse": torch.from_numpy(inds)},
                            {"per_ray_error": torch.from_numpy(err)})
    np.testing.assert_allclose(ds.error_map.numpy(), want, rtol=1.2e-7, atol=0)


def test_sample_pdf_matches_jax():
    """Random and midpoint quantiles over weights with zeros and peaks, and
    rays that miss the box (every bin at the 3e38 sentinel, weights 0):
    fp32, the same cumsum and interpolation (limit 1e-5 of the bin range;
    the sentinel rows exactly 3e38, finite)."""
    rng = np.random.default_rng(3)
    n, T, k = 64, 31, 24
    bins = np.sort(rng.uniform(0.5, 3.5, (n, T + 1)), -1).astype(np.float32)
    w = rng.uniform(0, 1, (n, T)).astype(np.float32) ** 4
    w[::5] = 0.0
    bins[-4:] = np.float32(3e38)
    w[-4:] = 0.0
    key = jax.random.key(9)
    u = np.asarray(jax.random.uniform(key, (n, k)))
    for det, tu in ((False, torch.from_numpy(u)), (True, None)):
        want = np.asarray(jrenderer.sample_pdf(key, jnp.asarray(bins), jnp.asarray(w), k, det=det))
        got = trenderer.sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), k, tu).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_array_equal(got[-4:], np.float32(3e38))
        np.testing.assert_allclose(got[:-4], want[:-4], rtol=0, atol=1e-5 * 3)


def test_render_image_upsampled_matches_jax(scene):
    """``render_image``'s uniform route with 16 importance samples at the
    midpoint quantiles (eval) against JAX's ``render_rays`` on the view's
    rays, fp32: as the uniform render check, 2e-5. JAX's ``render_rays``
    runs unjitted, and the table is U(-0.25, 0.25): the importance samples
    gather where the field is steep, and there a jitted chunk's contracted
    FMAs, or the two packages' ray directions 1 ulp apart, move the image
    ~1e-4 with U(-1, 1) tables."""
    from focnerf_tpu.core.rays import get_rays as jget_rays
    from focnerf_tpu_torch.data.provider import DatasetOptions, NeRFDataset

    jcfg = jnerf.NeRFConfig(**SMALL, compute_dtype=jnp.float32)
    tcfg = tnerf.NeRFConfig(**SMALL, compute_dtype=torch.float32)
    jp = make_jax_params(jcfg, grid_scale=0.25)
    jp["sigma_net"][-1][:, 0] *= 4.0  # a visible object
    ds = NeRFDataset(DatasetOptions(path=scene, scale=1.0), split="val", device="cpu")
    feat = np.random.default_rng(0).normal(size=144).astype(np.float32)
    kw = dict(bg_color=1.0, min_near=0.2, num_steps=32, upsample_steps=16)
    rays = jget_rays(jnp.asarray(ds.poses[0]), ds.intrinsics, ds.H, ds.W)
    out = jrenderer.render_rays(jp, jcfg, rays["rays_o"], rays["rays_d"], obj_feat=jnp.asarray(feat), **kw)
    jimg = np.asarray(out["image"]).reshape(ds.H, ds.W, 3)
    jdepth = np.asarray(out["depth"]).reshape(ds.H, ds.W)
    timg, tdepth = trenderer.render_image(interop.params_from_jax(jp, tcfg, "cpu"), tcfg, ds.poses[0],
                                          ds.intrinsics, ds.H, ds.W, obj_feat=feat, max_ray_batch=384, **kw)
    assert 0.05 < float((1.0 - jimg).mean()) < 0.95  # a visible object
    np.testing.assert_allclose(timg.numpy(), jimg, atol=2e-5)
    np.testing.assert_allclose(tdepth.numpy(), jdepth, atol=2e-5)


N_RAYS, T, UP = 64, 32, 16


def _uniform_draws(key, cfg, tv):
    """The draws JAX's ``make_train_step`` makes from ``key``, in its order."""
    k_bg, k_perturb = jax.random.split(key)
    rng, k_pert = jax.random.split(k_perturb)
    rng, k_up = jax.random.split(rng)
    from focnerf_tpu_torch.ops.hashgrid import stochastic_levels

    spec = cfg.encode_spec
    draws = {"bg": to_t(jax.random.uniform(k_bg, (N_RAYS, 3))), "z_noise": to_t(jax.random.uniform(k_pert, (N_RAYS, T))),
             "pdf_u": to_t(jax.random.uniform(k_up, (N_RAYS, UP))),
             "u": to_t(jax.random.uniform(jax.random.fold_in(rng, 7),
                                          (N_RAYS * (T + UP), len(stochastic_levels(spec)), spec.stochastic_k, 3)))}
    if tv:
        draws["tv_x"] = to_t(jax.random.uniform(jax.random.fold_in(key, 11), (8192, 3)))
    return draws


@pytest.mark.parametrize("variant", ["exact", "stochastic"])
def test_uniform_train_step_matches_jax(variant):
    """One step of ``make_train_step`` (32 jittered samples + 16 importance
    samples, TV 1e-2, alpha 0.1, the mask penalty; a few rays miss the box),
    unjitted, against the port's from the same params and JAX's draws, fp32:
    loss within 1e-5 relative and ``per_ray_error`` 1e-5 (sums in another
    order); the MLPs' gradients within 1e-4 of their largest entry, the
    table's within 1e-3. The importance samples sit where the coarse
    weights put them, and those weights' last bits differ: a sample moved
    by 1e-6 shifts its trilinear weights on the finest level (a cell is
    1/2048 of the box) by ~1e-3 (measured: table 3.1e-4, MLPs 3.7e-5; 7e-7
    and 4e-7 without upsampling). JAX's jitted step is not the reference
    here: on these inputs its table gradient differs from its own unjitted
    step's by up to 6% of the largest entry."""
    extra = dict(stochastic_corners=1, stochastic_min_size=1) if variant == "stochastic" else {}
    jcfg = jnerf.NeRFConfig(**SMALL, **extra, compute_dtype=jnp.float32)
    tcfg = tnerf.NeRFConfig(**SMALL, **extra, compute_dtype=torch.float32)
    params = make_jax_params(jcfg, grid_scale=0.5)
    params["sigma_net"][-1][:, 0] *= 4.0
    b = _batch(N_RAYS)
    b["rays_d"][-3:] *= -1.0  # away from the box: the near/far sentinel
    opt = jstate.make_optimizer(lr=1e-2, iters=100)
    kw = dict(num_steps=T, upsample_steps=UP, tv_weight=1e-2, alpha_weight=0.1)
    step = jsteps.make_train_step(jcfg, opt, donate=False, **kw).raw  # unjitted: no contracted FMAs
    s = jstate.create_train_state(jax.random.key(0), jcfg, opt, params=jax.tree.map(jnp.asarray, params))
    key = jax.random.key(4)
    s1, m1 = step(s, {k: jnp.asarray(v) for k, v in b.items()}, key)

    p = clone_params(interop.params_from_jax(params, tcfg, "cpu"), requires_grad=True)
    tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
    loss, aux = tsteps.uniform_loss(p, tcfg, tbatch, _uniform_draws(key, tcfg, tv=True), **kw)
    loss.backward()
    assert np.isfinite(float(loss)) and all(torch.isfinite(t.grad).all() for t in param_leaves(p))
    np.testing.assert_allclose(float(loss.detach()), float(m1["loss"]), rtol=1e-5)
    np.testing.assert_allclose(aux["per_ray_error"].numpy(), np.asarray(m1["per_ray_error"]), rtol=1e-5, atol=1e-7)
    jgrads = [m / 0.1 for m in _leaves(s1.opt_state[0].mu)]  # Adam's first moment from 0: 0.1 g
    for i, (got, want) in enumerate(zip([t.grad.numpy() for t in param_leaves(p)], jgrads)):
        tol = 1e-3 if i == 0 else 1e-4  # leaf 0 is the table
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


# the ``O2`` case is tests/test_torch_uniform_o2.py's: each case is a CLI
# run, and --dist loadfile gives a file to one worker
@pytest.mark.parametrize("mode", ["uniform"])
def test_main_nerf_trains_the_new_modes(tmp_path, mode):
    check_main_nerf_trains_the_new_modes(tmp_path, mode)


def check_main_nerf_trains_the_new_modes(tmp_path, mode):
    """``main_nerf`` without ``-O`` (upsampling, error map, TV) and with
    ``-O2`` (c2f stages and P = 2, patches, TV): the losses fall, the error
    map leaves its 0.1 fill on the trained cells, and the mesh is written.
    (Patches take the place of the error map, as in JAX: a patch batch has
    no coarse cells.)"""
    from focnerf_tpu_torch.apps import main_nerf
    from focnerf_tpu_torch.ops.hashgrid import hashgrid_table_grad

    scene = make_synthetic_scene(str(tmp_path / "scene"), n_train=4, n_val=1)
    ws = str(tmp_path / "ws")
    argv = [scene, "--workspace", ws, "--disable_yolo", "--scale", "1.0", "--bound", "1.0", "--grid_levels", "4",
            "--num_rays", "256", "--iters", "24", "--max_ray_batch", "1024", "--mesh_res", "24",
            "--tv_weight", "1e-4"]
    if mode == "uniform":
        argv += ["--num_steps", "24", "--upsample_steps", "8", "--error_map"]
    else:
        argv += ["-O2", "--c2f", "8:2,16:3", "--patch_size", "4"]
    from focnerf_tpu_torch.data import provider

    seen, real = [], provider.NeRFDataset

    class Spy(real):  # keeps the train split, whose error map the trainer updates
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen.append(self)

    provider.NeRFDataset = Spy
    try:
        (tr,) = main_nerf.main(argv, device="cpu")
    finally:
        provider.NeRFDataset = real
    assert hashgrid_table_grad.launches == 0  # CPU: the plain version
    losses = np.asarray(tr.step_losses)
    assert len(losses) == 24 and np.isfinite(losses).all() and losses[-6:].mean() < losses[:6].mean()
    assert (tr.occupancy is None) == (mode == "uniform")
    assert tr.grad_level_phases == (2 if mode == "O2" else 0)
    em = seen[0].error_map
    if mode == "uniform":
        assert bool((em != 0.1).any(-1).all())  # every view trained
    else:
        assert em is None
    assert np.isfinite(tr.last_eval_results["PSNR"])
    mesh = os.path.join(f"{ws}_background", "meshes", f"ngp_{tr.epoch}.obj")
    assert os.path.exists(mesh)
