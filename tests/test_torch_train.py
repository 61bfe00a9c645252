"""The training slice as a whole on the CPU: Adam, LR and EMA against
optax (a), one ``train_step_occupancy`` against the JAX package's
``make_train_step_occupancy`` from a JAX state carried across, at a small
width and at the default full width (b), the meters (c), and ``main_nerf
-O`` training, resuming, exporting its mesh and serving end to end (d)."""

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
from test_torch_render import sphere_density_grid  # noqa: E402

from focnerf_tpu.models import nerf as jnerf  # noqa: E402
from focnerf_tpu.ops.occupancy import occupancy_skip_field as jskip_field  # noqa: E402
from focnerf_tpu.train import state as jstate  # noqa: E402
from focnerf_tpu_torch import interop  # noqa: E402
from focnerf_tpu_torch.models import nerf as tnerf  # noqa: E402
from focnerf_tpu_torch.ops.hashgrid import stochastic_levels  # noqa: E402
from focnerf_tpu_torch.train.state import TrainState, clone_params, param_leaves  # noqa: E402
from focnerf_tpu_torch.train.steps import occupancy_loss, train_step_occupancy  # noqa: E402

start_torch_threads()


def _leaves(tree):
    """A JAX or port params tree -> its arrays in the port's leaf order."""
    if isinstance(tree, dict) and torch.is_tensor(next(iter(param_leaves(tree)), None)):
        return [t.detach().numpy() for t in param_leaves(tree)]
    order = ["grid", "bg_grid", "sigma_net", "color_net", "yolo_net", "bg_net"]
    return [np.asarray(a) for k in order if k in tree
            for a in (tree[k] if isinstance(tree[k], list) else [tree[k]])]


# ------------------------------------------------------- (a) Adam, LR, EMA
@pytest.mark.parametrize(
    "kw",
    [dict(), dict(lr_net=1e-3), dict(warmup=3), dict(grad_clip=0.05)],
    ids=["plain", "lr_net", "warmup", "clip"],
)
def test_adam_lr_ema_match_optax(kw):
    cfg = jnerf.NeRFConfig(**SMALL)
    tcfg = tnerf.NeRFConfig(**SMALL)
    params = make_jax_params(cfg, grid_scale=0.1)
    opt = jstate.make_optimizer(lr=1e-2, iters=5, lr_net=kw.get("lr_net"),
                                warmup=kw.get("warmup", 0), grad_clip=kw.get("grad_clip", 0.0))
    js = jstate.create_train_state(jax.random.key(0), cfg, opt, params=jax.tree.map(jnp.asarray, params))
    ts = TrainState(interop.params_from_jax(params, tcfg, "cpu"), lr=1e-2, iters=5, **kw)
    rng = np.random.default_rng(0)
    for step in range(7):  # past iters: the LR factor stops at 0.1
        grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), params)
        updates, opt_state = opt.update(jax.tree.map(jnp.asarray, grads), js.opt_state, js.params)
        new = jax.tree.map(lambda p, u: p + u, js.params, updates)
        js = js._replace(params=new, opt_state=opt_state, step=js.step + 1,
                         ema_params=jstate.ema_update(js.ema_params, new, js.ema_count),
                         ema_count=js.ema_count + 1)
        for p, g in zip(param_leaves(ts.params), _leaves(grads)):
            p.grad = torch.from_numpy(g)
        ts.apply_gradients()
        # fp32: the same Adam arithmetic (eps 1e-15 outside the sqrt) and
        # EMA, grouped differently; O(1) gradients, so no sign-sensitive rows
        for got, want in zip(_leaves(ts.params), _leaves(js.params)):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
        for got, want in zip(_leaves(ts.ema_params), _leaves(js.ema_params)):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert ts.step == int(js.step) == 7


# ------------------------------------------------------------ (b) train step
SMALL_O = dict(SMALL, stochastic_corners=1, stochastic_min_size=1)
SLAB, N_RAYS = 32, 64


def _batch(n=N_RAYS, seed=0):
    from focnerf_tpu_torch.core.camera import rand_poses

    rng = np.random.default_rng(seed)
    pose = rand_poses(rng, 1, radius=2.5)[0]
    d = rng.normal(size=(n, 3)).astype(np.float32) * 0.15 + pose[:3, 2]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return {
        "rays_o": np.broadcast_to(pose[:3, 3], d.shape).astype(np.float32).copy(),
        "rays_d": d.astype(np.float32),
        "pixels": rng.uniform(0, 1, (n, 4)).astype(np.float32),
        "ray_mask": rng.uniform(size=n) < 0.7,
        "obj_feat": rng.normal(size=144).astype(np.float32),
    }


def _step_draws(key, tcfg):
    """The draws the JAX step makes from ``key``, in its order and shapes."""
    k_bg, k_perturb = jax.random.split(key)
    n_stoch = len(stochastic_levels(tcfg.grid_spec))
    to = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return {
        "bg": to(jax.random.uniform(k_bg, (N_RAYS, 3))),
        "noise": to(jax.random.uniform(k_perturb, (N_RAYS,))),
        "u": to(jax.random.uniform(jax.random.fold_in(k_perturb, 7), (N_RAYS * SLAB, n_stoch, 1, 3))),
    }


# (loss rel, grad atol / max|g|, params atol / lr) per dtype, with the reason:
#  fp32: the same draws and march, products summed in another order;
#  bf16: both sides round the same operands to bf16, but a 1-ulp fp32
#        difference can round a hidden unit to the neighbouring bf16 value,
#        and the backward rounds its cotangents at other places.
#  (measured: fp32 9e-8, 3.2e-6, 6e-6; bf16 9e-8, 1.7e-3, 4.6e-4)
STEP_TOL = {"float32": (1e-5, 1e-5, 1e-4), "bfloat16": (1e-4, 5e-3, 5e-3)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_matches_jax(dtype):
    _check_occupancy_step(SMALL_O, dtype, min_live=0.01)


# -O at the default width (16 levels x 2, a 2^19 table, 64-wide MLPs) at
# F4's bound 1: the table's hashed levels and the full MLPs, which the small
# config does not reach. Only ~0.5% of the 6.3M table rows see a sample.
FULL_O = dict(bound=1.0, stochastic_corners=1, stochastic_min_size=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_width_O_step_matches_jax(dtype):
    _check_occupancy_step(FULL_O, dtype, min_live=1e-3)


def _check_occupancy_step(cfg_kw, dtype, min_live):
    """One -O step of the port against ``make_train_step_occupancy`` from a
    JAX state carried across (params, Adam moments, EMA), on the same batch,
    skip field and draws: loss, gradients and the update at STEP_TOL."""
    from focnerf_tpu.train.steps import make_train_step_occupancy

    jcfg = jnerf.NeRFConfig(**cfg_kw, compute_dtype=getattr(jnp, dtype))
    tcfg = tnerf.NeRFConfig(**cfg_kw, compute_dtype=getattr(torch, dtype))
    params = make_jax_params(jcfg, grid_scale=0.5)
    params["sigma_net"][-1][:, 0] *= 4.0  # a visible object
    lr, iters = 1e-2, 100
    opt = jstate.make_optimizer(lr=lr, iters=iters)
    step = make_train_step_occupancy(jcfg, opt, dt_gamma=1 / 128, max_steps=1024, slab=SLAB,
                                     skip_field=True, donate=False)
    skip = jskip_field(jnp.asarray(sphere_density_grid(1.0) > 10.0))
    b = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in b.items()}
    tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}

    s = jstate.create_train_state(jax.random.key(0), jcfg, opt, params=jax.tree.map(jnp.asarray, params))
    for k in (1, 2):  # a non-zero Adam state to carry across
        s, _ = step(s, jbatch, skip, jax.random.key(k))
    adam = s.opt_state[0]
    np_ = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    ts = interop.train_state_from_jax(
        params=np_(s.params), mu=np_(adam.mu), nu=np_(adam.nu), count=int(adam.count),
        ema_params=np_(s.ema_params), ema_count=int(s.ema_count), step=int(s.step),
        cfg=tcfg, device="cpu", lr=lr, iters=iters,
    )
    key = jax.random.key(3)
    s3, m3 = step(s, jbatch, skip, key)
    draws = _step_draws(key, tcfg)
    tskip = torch.from_numpy(np.array(skip))
    kw = dict(dt_gamma=1 / 128, max_steps=1024, slab=SLAB, skip_field=True)
    loss_rel, g_tol, p_tol = STEP_TOL[dtype]

    # loss and gradients, on a copy of the carried params
    p = clone_params(ts.params, requires_grad=True)
    loss, aux = occupancy_loss(p, tcfg, tbatch, tskip, draws, **kw)
    loss.backward()
    assert float(aux["n_samples"].float().mean()) > 4  # rays cross the object
    np.testing.assert_allclose(float(loss.detach()), float(m3["loss"]), rtol=loss_rel)
    # the JAX step's gradient, from Adam's first moment: mu3 = 0.9 mu2 + 0.1 g
    b1 = 0.9
    jgrads = [(n3 - b1 * n2) / (1 - b1)
              for n3, n2 in zip(_leaves(s3.opt_state[0].mu), _leaves(adam.mu))]
    for got, want in zip([t.grad.numpy() for t in param_leaves(p)], jgrads):
        np.testing.assert_allclose(got, want, rtol=0, atol=g_tol * np.abs(want).max())

    # the update from the carried state
    metrics = train_step_occupancy(ts, tbatch, tskip, draws, cfg=tcfg, **kw)
    assert ts.step == int(s3.step) == 3 and float(metrics["loss"]) == float(loss.detach())
    for got, want, g, mu2 in zip(_leaves(ts.params), _leaves(s3.params), jgrads, _leaves(adam.mu)):
        # Adam with eps 1e-15 turns a gradient seen for the first time into
        # a +-lr step whatever its size, so an entry whose gradient is at the
        # rounding level may step either way: compare where this step's or
        # the carried gradient clears 1e-3 of the largest
        floor = 1e-3 * np.abs(g).max()
        live = (np.abs(g) > floor) | (np.abs(mu2) > floor)
        assert live.mean() > min_live
        np.testing.assert_allclose(got[live], want[live], rtol=0, atol=p_tol * lr)
    for got, want in zip(_leaves(ts.ema_params), _leaves(s3.ema_params)):
        np.testing.assert_allclose(got, want, rtol=0, atol=p_tol * lr)


# ------------------------------------------------------------------ (c) meters
def test_meters_match_jax():
    from focnerf_tpu.train import meters as jmeters
    from focnerf_tpu_torch.train import meters as tmeters

    rng = np.random.default_rng(0)
    gt = rng.uniform(0, 1, (40, 48, 3)).astype(np.float32)
    pred = np.clip(gt + rng.normal(scale=0.05, size=gt.shape), 0, 1).astype(np.float32)
    for name in ("psnr", "ssim"):
        want = float(getattr(jmeters, name)(jnp.asarray(pred), jnp.asarray(gt)))
        got = float(getattr(tmeters, name)(torch.from_numpy(pred), torch.from_numpy(gt)))
        np.testing.assert_allclose(got, want, rtol=1e-5)  # fp32 sums in another order


# ---------------------------------------------------- (d) main_nerf end to end
# the ``iter`` case is tests/test_torch_train_iter.py's: each case is a few
# CLI runs, and --dist loadfile gives a file to one worker
@pytest.mark.parametrize("eval_renderer", ["oneshot"])
def test_main_nerf_trains_resumes_and_serves(tmp_path, eval_renderer):
    check_main_nerf_trains_resumes_and_serves(tmp_path, eval_renderer)


def check_main_nerf_trains_resumes_and_serves(tmp_path, eval_renderer):
    """``main_nerf -O`` training, resuming, exporting its mesh and serving
    on the CPU with ``eval_renderer``; ``iter`` is the CLI's default: it is
    not passed."""
    from focnerf_tpu_torch.apps import main_nerf
    from focnerf_tpu_torch.data.png import read_image
    from focnerf_tpu_torch.ops.composite import composite_rays_fused, composite_rays_resume
    from focnerf_tpu_torch.ops.hashgrid import hashgrid_table_grad
    from focnerf_tpu_torch.render.iterative import render_rays_iterative
    from focnerf_tpu_torch.train.checkpoints import CheckpointManager
    from focnerf_tpu_torch.train.trainer import Trainer

    scene = make_synthetic_scene(str(tmp_path / "scene"), n_train=4, n_val=1)
    ws = str(tmp_path / "ws")
    common = [scene, "-O", "--workspace", ws, "--disable_yolo", "--scale", "1.0", "--bound", "1.0",
              "--grid_levels", "4", "--num_rays", "256", "--max_ray_batch", "1024", "--mesh_res", "32"]
    if eval_renderer != "iter":
        common += ["--eval_renderer", eval_renderer]
    render_rays_iterative.rounds = 0
    (tr,) = main_nerf.main(common + ["--iters", "32"], device="cpu")
    assert composite_rays_fused.launches == 0 and hashgrid_table_grad.launches == 0  # CPU
    assert composite_rays_resume.launches == 0
    assert (render_rays_iterative.rounds > 0) == (eval_renderer == "iter")  # the eval's renderer
    losses = tr.step_losses
    assert len(losses) == 32 and np.isfinite(losses).all()
    assert np.mean(losses[-8:]) < 0.6 * np.mean(losses[:8])  # it learns
    assert tr.last_eval_step == 32 and tr.last_eval_results["PSNR"] > 0
    ckpt = os.path.join(f"{ws}_background", "checkpoints")
    assert CheckpointManager(ckpt).steps() == [28, 32]  # rolling, two kept
    assert os.path.exists(os.path.join(f"{ws}_background", "best", "best.pt"))
    with open(os.path.join(ws, "train_times.txt")) as f:
        assert f.read().startswith("background:")
    assert os.path.exists(os.path.join(f"{ws}_background", "meshes", f"ngp_{tr.epoch}.obj"))  # --mesh_res

    # --ckpt latest resumes at the saved step with the saved Adam state
    (tr2,) = main_nerf.main(common + ["--iters", "36"], device="cpu")
    assert len(tr2.step_losses) == 4 and tr2.global_step == 36 and tr2.state.step == 36
    assert tr2.state.optimizer.state_dict()["state"][0]["step"] == 36
    # --ckpt best: the best eval's state, without the grid
    best = Trainer("ngp", tr.cfg, workspace=f"{ws}_background", use_checkpoint="best",
                   use_occupancy=True, device="cpu")
    assert best.global_step in (32, 36)

    main_nerf.main(common + ["--test"], device="cpu")
    img = read_image(os.path.join(f"{ws}_background", "results", "ngp_0000.png"))
    assert img.shape == (32, 32, 3)
