"""The D-NeRF training slice on the CPU: one step of each variant against
the JAX package's unjitted (``.raw``) step from the same state, batch and
draws (loss, every gradient, the update), and ``DNeRFTrainer`` /
``main_dnerf`` end to end (train, resume with the time grid, the skip
field, the time-conditioned mesh, ``--test``), mirroring
tests/test_dnerf.py's trainer tests."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from helpers import make_synthetic_scene  # noqa: E402
from test_torch_dnerf import GRAD_TOL, configs, make_dnerf_params  # noqa: E402
from test_torch_render import sphere_density_grid  # noqa: E402

from focnerf_tpu.ops.occupancy import occupancy_skip_field as jskip_field  # noqa: E402
from focnerf_tpu.train import dnerf_steps as jsteps  # noqa: E402
from focnerf_tpu.train import state as jstate  # noqa: E402
from focnerf_tpu_torch import interop  # noqa: E402
from focnerf_tpu_torch.train import dnerf_steps as tsteps  # noqa: E402
from focnerf_tpu_torch.train.state import clone_params, param_leaves  # noqa: E402

N_RAYS, SLAB, STEPS = 64, 32, 48


def _batch(seed=0):
    from focnerf_tpu_torch.core.camera import rand_poses

    rng = np.random.default_rng(seed)
    pose = rand_poses(rng, 1, radius=2.5)[0]
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32) * 0.15 + pose[:3, 2]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return {
        "rays_o": np.broadcast_to(pose[:3, 3], d.shape).astype(np.float32).copy(),
        "rays_d": d.astype(np.float32),
        "pixels": rng.uniform(0, 1, (N_RAYS, 4)).astype(np.float32),
        "time": np.float32(0.4),
    }


def _jax_leaves(tree, keys):
    return [np.asarray(a) for k in keys for a in (tree[k] if isinstance(tree[k], list) else [tree[k]])]


@pytest.mark.parametrize("variant,path", [("deform", "skip"), ("basis", "ladder"), ("hyper", "skip"),
                                          ("deform", "uniform")])
def test_step_matches_jax(variant, path):
    """A step from a fresh JAX state (params carried across): the loss, the
    gradient of every parameter (JAX's from Adam's first moment, mu = 0.1 g;
    at test_torch_dnerf.GRAD_TOL) and the update, fp32."""
    jcfg, tcfg = configs(variant)
    # the interpolation's gradient jumps where a point crosses a cell face,
    # and the warped (lifted) points carry 1-ulp differences, so a sample
    # within an ulp of a face may land on either side: with seed 4 one hyper
    # sample does, and moves hyper_net's gradient by 5e-4 of its largest
    # entry. No sample of these params' batch sits that close to a face.
    params = make_dnerf_params(jcfg, seed=5, warp=1.0, fine=0.0)
    lr, iters = 1e-2, 100
    opt = jstate.make_optimizer(lr=lr, iters=iters)
    s = jstate.create_train_state(jax.random.key(0), jcfg, opt, params=jax.tree.map(jnp.asarray, params))
    b = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in b.items()}
    tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
    key = jax.random.key(5)
    k_bg, k_perturb = jax.random.split(key)
    to = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    draws = {"bg": to(jax.random.uniform(k_bg, (N_RAYS, 3)))}
    if path == "uniform":
        jstep = jsteps.make_dnerf_train_step(jcfg, opt, num_steps=STEPS).raw
        s1, m1 = jstep(s, jbatch, key)
        draws["z_noise"] = to(jax.random.uniform(k_perturb, (N_RAYS, STEPS)))
        kw = dict(num_steps=STEPS)
        loss_fn, step_fn, occ = tsteps.dnerf_loss, tsteps.dnerf_train_step, ()
    else:
        skip = path == "skip"
        bits = jnp.asarray(sphere_density_grid(1.0) > 10.0)
        jocc = jskip_field(bits) if skip else bits
        jstep = jsteps.make_dnerf_train_step_occupancy(jcfg, opt, dt_gamma=1 / 128, slab=SLAB,
                                                       skip_field=skip).raw
        s1, m1 = jstep(s, jbatch, jocc, key)
        draws["noise"] = to(jax.random.uniform(k_perturb, (N_RAYS,)))
        kw = dict(dt_gamma=1 / 128, slab=SLAB, skip_field=skip)
        loss_fn, step_fn, occ = tsteps.dnerf_loss_occupancy, tsteps.dnerf_train_step_occupancy, (to(jocc),)

    ts = interop.train_state_from_jax(
        params=params, mu=jax.tree.map(np.zeros_like, params), nu=jax.tree.map(np.zeros_like, params), count=0,
        ema_params=params, ema_count=0, step=0, cfg=tcfg, device="cpu", lr=lr, iters=iters,
    )
    keys = list(ts.params)
    p = clone_params(ts.params, requires_grad=True)
    loss, aux = loss_fn(p, tcfg, tbatch, *occ, draws, **kw)
    loss.backward()
    if path != "uniform":
        assert float(aux["n_samples"].float().mean()) > 4  # rays cross the object
    np.testing.assert_allclose(float(loss.detach()), float(m1["loss"]), rtol=1e-5)
    jgrads = [m / 0.1 for m in _jax_leaves(s1.opt_state[0].mu, keys)]
    kinds = [("grid" if k == "grid" and variant != "basis" else "other")
             for k in keys for _ in (ts.params[k] if isinstance(ts.params[k], list) else [0])]
    for got, want, kind in zip([t.grad.numpy() for t in param_leaves(p)], jgrads, kinds):
        np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_TOL[kind] * np.abs(want).max())
    net = {"deform": "deform_net", "hyper": "hyper_net", "basis": "basis_net"}[variant]
    assert all(float(w.grad.abs().max()) > 0 for w in p[net])  # fed by the position gradient

    metrics = step_fn(ts, tbatch, *occ, draws, cfg=tcfg, **kw)
    assert ts.step == int(s1.step) == 1 and float(metrics["loss"]) == float(loss.detach())
    for got, want, g in zip([t.detach().numpy() for t in param_leaves(ts.params)],
                            _jax_leaves(s1.params, keys), jgrads):
        # the first Adam step is +-lr wherever the gradient is not at the
        # rounding level: compare where it clears 1e-3 of the largest
        live = np.abs(g) > 1e-3 * np.abs(g).max()
        np.testing.assert_allclose(got[live], want[live], rtol=0, atol=1e-4 * lr)


SMALL_TRAINER = dict(num_levels=4, base_resolution=4, log2_hashmap_size=11, deform_layers=2, deform_hidden=16,
                     hidden_dim=16, hidden_dim_color=16, use_objfeat=False, compute_dtype=torch.float32,
                     bound=1.0)


def test_trainer_trains_resumes_meshes_and_serves(tmp_path):
    from focnerf_tpu_torch.apps import main_dnerf
    from focnerf_tpu_torch.data.dnerf_provider import DNeRFDataset
    from focnerf_tpu_torch.data.png import read_image
    from focnerf_tpu_torch.data.provider import DatasetOptions
    from focnerf_tpu_torch.models.dnerf import DNeRFConfig
    from focnerf_tpu_torch.render.dnerf_renderer import TimeOccupancyState
    from focnerf_tpu_torch.train.dnerf_trainer import DNeRFTrainer

    scene = make_synthetic_scene(str(tmp_path / "scene"), n_train=3, n_val=1, H=16, W=16)
    cfg = DNeRFConfig(variant="deform", **SMALL_TRAINER)
    dopt = DatasetOptions(path=scene, num_rays=64, scale=1.0)
    train_ds = DNeRFDataset(dopt, split="train", device="cpu")
    ws = str(tmp_path / "ws")
    kw = dict(workspace=ws, lr=1e-2, iters=100, num_steps=32, max_ray_batch=256, use_occupancy=True,
              dt_gamma=0.0, max_steps=64, train_slab=16, update_extra_interval=4, eval_interval=1000,
              time_slots=4, skip_march=True, device="cpu")
    tr = DNeRFTrainer("dnerf", cfg, **kw)
    tr.train(train_ds, None, max_epochs=2, steps_per_epoch=4)
    assert tr.global_step == 8 and np.isfinite(tr.step_losses).all()
    grid = tr.occupancy.density_grid
    assert int(tr.occupancy.iter_density) == 2 and grid.shape == (4, 1, 128**3)
    assert [bool((grid[k] > 0).any()) for k in range(4)] == [True, True, False, False]  # slots 0, 1
    occ = tr._occ_bits_for_batch({"time": torch.tensor(0.25)})  # slot 1's skip field
    assert occ.dtype == torch.uint8 and occ.shape == (1, 128**3)
    assert tr._occ_bits_for_batch({"time": torch.tensor(0.3)}) is occ  # cached until the next refresh

    # resume: a fresh trainer picks up the step and the time grid
    tr2 = DNeRFTrainer("dnerf", cfg, **{**kw, "use_checkpoint": "latest"})
    assert tr2.global_step == 8 and isinstance(tr2.occupancy, TimeOccupancyState)
    assert torch.equal(tr2.occupancy.density_grid, grid)
    tr2.train(train_ds, None, max_epochs=1, steps_per_epoch=2)
    assert tr2.global_step == 10 and int(tr2.occupancy.iter_density) == 3

    val_ds = DNeRFDataset(dopt, split="val", device="cpu")
    res = tr2.evaluate(val_ds, save_images=False)
    assert np.isfinite(res["PSNR"]) and tr2.last_eval_step == tr2.global_step
    path = tr2.save_mesh(resolution=24, threshold=0.5, t=0.5)
    assert path.endswith("t0.50.obj") and os.path.exists(path)

    # --test rebuilds the trained (small) field from model_config.json
    out = main_dnerf.main([scene, "--test", "-O", "--workspace", ws, "--scale", "1.0", "--bound", "1.0",
                           "--max_ray_batch", "256", "--time_slots", "4"], device="cpu")
    assert out.cfg == cfg and out.global_step == 10
    img = read_image(os.path.join(ws, "results", "dnerf_0000.png"))
    assert img.shape == (16, 16, 3)


def test_uniform_trainer_and_ignored_options(tmp_path, capsys):
    from focnerf_tpu_torch.apps.main_dnerf import warn_ignored
    from focnerf_tpu_torch.config import parse_options
    from focnerf_tpu_torch.data.dnerf_provider import DNeRFDataset
    from focnerf_tpu_torch.data.provider import DatasetOptions
    from focnerf_tpu_torch.models.dnerf import DNeRFConfig
    from focnerf_tpu_torch.train.dnerf_trainer import DNeRFTrainer

    scene = make_synthetic_scene(str(tmp_path / "scene"), n_train=3, n_val=1, H=16, W=16)
    for variant in ("basis", "hyper"):
        tr = DNeRFTrainer("dnerf", DNeRFConfig(variant=variant, **SMALL_TRAINER), workspace=str(tmp_path / variant),
                          num_steps=24, max_ray_batch=256, eval_interval=1000, device="cpu")
        ds = DNeRFDataset(DatasetOptions(path=scene, num_rays=64, scale=1.0), split="train", device="cpu")
        tr.train(ds, None, max_epochs=1, steps_per_epoch=3)
        assert tr.occupancy is None and np.isfinite(tr.step_losses).all() and len(tr.step_losses) == 3
    warn_ignored(parse_options(["s", "-O", "--grid_levels", "4", "--tv_weight", "1e-4"]))
    said = capsys.readouterr().out
    for name in ("grid_levels", "tv_weight", "stochastic_corners", "bucket_slabs", "eval_renderer"):
        assert f"--{name} " in said
    assert "--lr " not in said
