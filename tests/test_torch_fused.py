"""The port's fused K-step dispatch (train/fused.py) against its per-step
loop and against the JAX package's chunk.

On the CPU the chunk is the per-step loop run from staged draws, so a
trainer at ``steps_per_dispatch`` K > 1 must reproduce the trainer at K = 1
bit for bit: losses, params, EMA params, the error map and the occupancy
grid (the bar of JAX's tests/test_fused_steps.py, which JAX meets up to its
scan's float noise). The chunk sizes follow JAX's ``_fused_steps_possible``
on the same settings. One small case feeds JAX's PRNG chain
(``split``/``fold_in`` as focnerf_tpu/train/fused.py draws it) to the
port's chunk and holds it to JAX's ``make_fused_chunk``.
"""

import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from helpers import make_synthetic_scene  # noqa: E402
from test_torch_model import start_torch_threads  # noqa: E402

from focnerf_tpu_torch import interop  # noqa: E402
from focnerf_tpu_torch.data.provider import DatasetOptions, NeRFDataset  # noqa: E402
from focnerf_tpu_torch.models.nerf import NeRFConfig  # noqa: E402
from focnerf_tpu_torch.train.fused import make_fused_chunk  # noqa: E402
from focnerf_tpu_torch.train.state import TrainState, param_leaves  # noqa: E402
from focnerf_tpu_torch.train.steps import train_step  # noqa: E402
from focnerf_tpu_torch.train.trainer import Trainer  # noqa: E402

start_torch_threads()

OCC = dict(use_occupancy=True, update_extra_interval=4, train_slab=16, max_steps=64, density_thresh=0.01,
           skip_march=True)


def _cfg(**kw):
    return NeRFConfig(num_levels=4, base_resolution=4, log2_hashmap_size=11, hidden_dim=16, hidden_dim_color=16,
                      geo_feat_dim=7, use_objfeat=False, compute_dtype=torch.float32, **kw)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_synthetic_scene(str(tmp_path_factory.mktemp("fused") / "scene"), n_train=3, n_val=1, H=16, W=16)


def _dataset(scene, error_map=False):
    return NeRFDataset(DatasetOptions(path=scene, num_rays=64, scale=1.0, error_map=error_map), split="train",
                       device="cpu")


def _trainer(tmp_path, tag, K, cfg=None, **kw):
    return Trainer(f"t{tag}", cfg or _cfg(), workspace=str(tmp_path / f"ws_{tag}"), iters=16, num_steps=16,
                   steps_per_dispatch=K, eval_interval=1000, eval_save_images=False, use_checkpoint="scratch",
                   seed=3, device="cpu", **kw)


def _train_pair(tmp_path, scene, K, steps, error_map=False, cfg=None, **kw):
    """(per-step trainer, fused trainer, their datasets, the fused chunk
    sizes) after ``steps`` steps of one epoch each."""
    runs = []
    for k in (1, K):
        ds = _dataset(scene, error_map)
        t = _trainer(tmp_path, f"{k}", k, cfg, **kw)
        sizes = []
        run = t._run_fused_chunk
        t._run_fused_chunk = lambda d, n, run=run, sizes=sizes: (sizes.append(n), run(d, n))[1]
        t.train(ds, None, max_epochs=1, steps_per_epoch=steps)
        runs.append((t, ds, sizes))
    (t1, ds1, _), (tk, dsk, sizes) = runs
    assert t1.global_step == tk.global_step == steps
    return t1, tk, ds1, dsk, sizes


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(param_leaves(a), param_leaves(b)))


def _assert_same_trajectory(t1, tk):
    assert t1.step_losses == tk.step_losses
    assert _same(t1.state.params, tk.state.params)
    assert _same(t1.state.ema_params, tk.state.ema_params)
    for p, q in zip(param_leaves(t1.state.params), param_leaves(tk.state.params)):
        s1, sk = t1.state.optimizer.state[p], tk.state.optimizer.state[q]
        assert torch.equal(s1["exp_avg"], sk["exp_avg"]) and torch.equal(s1["exp_avg_sq"], sk["exp_avg_sq"])
        assert float(s1["step"]) == float(sk["step"])
    assert (t1.state.step, t1.state.ema_count) == (tk.state.step, tk.state.ema_count)


def test_uniform_chunk_equals_per_step(tmp_path, scene):
    """Uniform sampling (no grid), 8 steps in chunks of 4 (stochastic
    corners: the draws ``u`` are staged too)."""
    t1, tk, *_, sizes = _train_pair(tmp_path, scene, 4, 8, cfg=_cfg(stochastic_corners=1, stochastic_min_size=1))
    assert sizes == [4, 4] and tk._fused_cache
    _assert_same_trajectory(t1, tk)


def test_error_map_chunk_equals_per_step(tmp_path, scene):
    """The error map's EMA runs inside each fused step: the map, its
    importance-sampled batches and the trajectory are the per-step loop's."""
    t1, tk, ds1, dsk, sizes = _train_pair(tmp_path, scene, 4, 6, error_map=True)
    assert sizes == [4, 2]
    assert torch.equal(ds1.error_map, dsk.error_map) and not torch.equal(ds1.error_map, torch.full_like(
        ds1.error_map, 0.1))
    _assert_same_trajectory(t1, tk)


def test_occupancy_chunks_stop_at_the_update_ticks(tmp_path, scene):
    """The skip-walk occupancy path at K = 8 with an update every 4 steps:
    chunks of 4 that end on the ticks (never across one), the grid updated
    where the per-step loop updates it, the same grid, walk iterations and
    trajectory."""
    t1, tk, *_, sizes = _train_pair(tmp_path, scene, 8, 12, **OCC)
    assert sizes == [4, 4, 4]
    assert torch.equal(t1.occupancy.density_grid, tk.occupancy.density_grid)
    assert t1.march_iters == tk.march_iters and len(tk.march_iters) == 12 and min(tk.march_iters) > 0
    _assert_same_trajectory(t1, tk)


def test_grad_level_phases_chunk_equals_per_step(tmp_path, scene):
    """``grad_level_phases`` 2: each chunk runs phase 0's and phase 1's step
    in turn (their level subsets fixed in the step)."""
    t1, tk, *_, sizes = _train_pair(tmp_path, scene, 4, 8, **dict(OCC, grad_level_phases=2))
    assert sizes == [4, 4]
    _assert_same_trajectory(t1, tk)


def test_grad_level_phases_require_occupancy(tmp_path):
    with pytest.raises(ValueError, match="grad_level_phases"):
        _trainer(tmp_path, "gp", 1, grad_level_phases=2)


def _jax_trainer(tmp_path, tag, K, **kw):
    from focnerf_tpu.models.nerf import NeRFConfig as JConfig
    from focnerf_tpu.train.trainer import Trainer as JTrainer

    jcfg = JConfig(num_levels=4, base_resolution=4, log2_hashmap_size=11, hidden_dim=16, hidden_dim_color=16,
                   geo_feat_dim=7, use_objfeat=False, compute_dtype=jnp.float32)
    return JTrainer(f"j{tag}", jcfg, workspace=str(tmp_path / f"jws_{tag}"), iters=16, num_steps=16,
                    steps_per_dispatch=K, eval_interval=1000, use_tensorboard=False, eval_save_images=False,
                    use_checkpoint="scratch", seed=3, **kw)


@pytest.mark.parametrize("case", ["rand_pose", "remainder", "ticks", "phases", "c2f", "no_images"])
def test_fused_steps_possible_matches_jax(tmp_path, case):
    """Chunk sizes (1 = per-step) of the port's trainer and JAX's on the
    same settings: the CLIP branch and a dataset without preloaded images
    stay per-step, an epoch remainder takes the largest power of two that
    fits, a chunk stops at the next occupancy tick and c2f boundary, and
    with gradient phases is a multiple of P starting on phase 0."""
    kw = {"ticks": dict(OCC, update_extra_interval=16), "phases": dict(OCC, grad_level_phases=2),
          "c2f": dict(OCC, update_extra_interval=64, c2f="6:2,10:3")}.get(case, {})
    kw = {k: v for k, v in kw.items() if k != "skip_march"}
    K = {"phases": 3, "ticks": 16, "c2f": 8}.get(case, 4)
    port, jx = _trainer(tmp_path, case, K, **kw), _jax_trainer(tmp_path, case, K, **kw)
    ds = types.SimpleNamespace(images=None if case == "no_images" else object())
    if case == "rand_pose":
        port.rand_pose = jx.rand_pose = 0
    answers = []
    for gs in (0, 1, 2, 3, 5, 6, 8, 9, 12, 15):
        port.global_step = jx.global_step = gs
        for remaining in (1, 2, 3, 5, 8, 16):
            got, want = port._fused_steps_possible(ds, remaining), jx._fused_steps_possible(ds, remaining)
            assert got == want, (case, gs, remaining, got, want)
            answers.append(got)
    assert (max(answers) > 1) == (case not in ("rand_pose", "no_images"))


def test_dnerf_trainer_stays_per_step():
    """As JAX's DNeRFTrainer (its ``_build_steps`` never enables the fused
    chunk), the port's D-NeRF trainer runs one step at a time."""
    from focnerf_tpu_torch.train.dnerf_trainer import DNeRFTrainer

    t = types.SimpleNamespace(steps_per_dispatch=4, rand_pose=-1, global_step=0, occupancy=None, c2f_stages=[],
                              grad_level_phases=0, _supports_fused=DNeRFTrainer._supports_fused)
    assert Trainer._fused_steps_possible(t, types.SimpleNamespace(images=object()), 8) == 1
    t._supports_fused = Trainer._supports_fused
    assert Trainer._fused_steps_possible(t, types.SimpleNamespace(images=object()), 8) == 4


def _voxel_scene(n_views, seed):
    from focnerf_tpu_torch.core.camera import rand_poses
    from focnerf_tpu_torch.render.baked import BakedVolume, render_baked

    g = torch.Generator().manual_seed(0)
    rgba = torch.rand((16, 16, 16, 4), generator=g)
    rgba[..., 3] *= 3.0
    vol = BakedVolume(rgba=rgba, bound=1.0, sh_deg=0)
    intr = (28.8, 28.8, 12.0, 12.0)
    poses = np.asarray(rand_poses(np.random.default_rng(seed), n_views, radius=2.5))
    imgs = np.stack([render_baked(vol, p, intr, 24, 24)[0].numpy() for p in poses])
    return poses, imgs, intr


@pytest.mark.parametrize("family", ["dense", "vm", "kplanes"])
def test_voxel_fused_equals_per_step(family):
    """``_fit_field_loop`` at ``steps_per_dispatch`` K: the same schedule,
    targets and per-variant steps as the per-step loop, bit for bit (the
    dense case ends on a short chunk: 22 = 8 + 8 + 6; K-planes feeds each
    view's own time as a tensor)."""
    from focnerf_tpu_torch.train.voxel import fit_voxels
    from focnerf_tpu_torch.train.voxel_kplanes import fit_kplanes
    from focnerf_tpu_torch.train.voxel_vm import fit_vm_voxels

    poses, imgs, intr = _voxel_scene(6, {"dense": 0, "vm": 1, "kplanes": 2}[family])
    if family == "dense":
        fit = lambda **k: fit_voxels(poses, imgs, intr, resolution=16, iters=22, lr=0.1, tv_weight=1e-5, seed=5,  # noqa: E731
                                     device="cpu", **k)
        K = 8
    elif family == "vm":
        fit = lambda **k: fit_vm_voxels(poses, imgs, intr, resolution=16, rank=4, iters=16, lr=0.05, seed=2,  # noqa: E731
                                        device="cpu", **k)
        K = 8
    else:
        times = np.linspace(0, 1, 6).astype(np.float32)
        fit = lambda **k: fit_kplanes(poses, imgs, times, intr, resolution=16, rank=2, time_res=4, iters=12,  # noqa: E731
                                      lr=0.05, seed=7, device="cpu", **k)
        K = 6
    (a, info_a), (b, info_b) = fit(), fit(steps_per_dispatch=K)
    leaves = lambda x: [x.rgba] if hasattr(x, "rgba") else ([x] if torch.is_tensor(x) else list(x))  # noqa: E731
    assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    assert np.array_equal(info_a["step_mse"], info_b["step_mse"]) and len(info_b["step_mse"]) == len(
        info_a["step_mse"])


def _jax_chain_draws(rng, n_views, H, W, n_rays, T, K):
    """JAX's fused chunk's draws for K uniform steps (focnerf_tpu/train/
    fused.py:75-80, data/provider.py's assembler, steps.py's loss) -> the
    port's (batch draws, step draws) per step."""
    to_t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    out = []
    for _ in range(K):
        rng, r = jax.random.split(rng)
        k_batch, k = jax.random.split(r)
        view = jax.random.randint(jax.random.fold_in(k_batch, 17), (), 0, n_views)
        k1, _ = jax.random.split(k_batch)
        inds = jax.random.randint(k1, (n_rays,), 0, H * W, dtype=jnp.int32)
        k_bg, k_perturb = jax.random.split(k)
        sub, k_pert = jax.random.split(k_perturb)
        _, k_up = jax.random.split(sub)
        bd = {"view": to_t(view).reshape(1).long(), "inds": to_t(inds).long()}
        sd = {"bg": to_t(jax.random.uniform(k_bg, (n_rays, 3))),
              "z_noise": to_t(jax.random.uniform(k_pert, (n_rays, T))),
              "pdf_u": to_t(jax.random.uniform(k_up, (n_rays, 0))),
              "u": torch.zeros((n_rays * T, 0, 0, 3))}
        out.append((bd, sd))
    return out


def test_chunk_matches_jax_make_fused_chunk(scene):
    """Four uniform steps, one chunk, from JAX's PRNG chain: the port's chunk
    (fed JAX's draws) against JAX's jitted ``make_fused_chunk`` from the
    same params. The losses agree within 1e-4 relative (the first step's
    within 1e-5: fp32 sums in another order); the params to JAX's own fused
    bar: at most 2% of the entries further than 2e-4 + 5% apart (a table
    entry with a near-zero gradient moves by a whole +-lr step under Adam's
    eps 1e-15 on either side of zero)."""
    from focnerf_tpu.data.provider import DatasetOptions as JOptions
    from focnerf_tpu.data.provider import NeRFDataset as JDataset
    from focnerf_tpu.models.nerf import NeRFConfig as JConfig
    from focnerf_tpu.train import state as jstate
    from focnerf_tpu.train.fused import make_fused_chunk as jchunk
    from focnerf_tpu.train.steps import make_train_step

    K, T, n_rays = 4, 16, 64
    small = dict(num_levels=4, base_resolution=4, log2_hashmap_size=11, hidden_dim=16, hidden_dim_color=16,
                 geo_feat_dim=7, use_objfeat=False)
    jcfg, tcfg = JConfig(**small, compute_dtype=jnp.float32), _cfg()
    opt = jstate.make_optimizer(lr=1e-2, iters=100)
    s0 = jstate.create_train_state(jax.random.key(0), jcfg, opt)
    jds = JDataset(JOptions(path=scene, num_rays=n_rays, scale=1.0), split="train")
    raw = make_train_step(jcfg, opt, num_steps=T, donate=False).raw
    fn = jchunk([raw], jds.assemble_fn(), jds.n_views, K=K, use_occupancy=False, has_error_map=False, donate=False)
    rng = jax.random.key(11)
    js, _, _, jlosses, _ = fn(s0, None, rng, None, *jds.fused_batch_inputs())

    tds = _dataset(scene)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    state = TrainState(interop.params_from_jax(np_tree(s0.params), tcfg, "cpu"), lr=1e-2, iters=100)
    step = lambda st, batch, occ, draws, hyper: train_step(st, batch, draws, cfg=tcfg, hyper=hyper,  # noqa: E731
                                                             num_steps=T)
    chunk = make_fused_chunk([step], tds.assemble_fn(), tds.fused_batch_inputs(), K=K, device="cpu",
                             has_error_map=False)
    draws = _jax_chain_draws(rng, tds.n_views, tds.H, tds.W, n_rays, T, K)
    losses, _, _ = chunk.run(state, None, draws, [state.hyper(k) for k in range(K)])
    state.advance(K)

    jl = np.asarray(jlosses)
    np.testing.assert_allclose(losses.numpy()[:1], jl[:1], rtol=1e-5)
    np.testing.assert_allclose(losses.numpy(), jl, rtol=1e-4)
    want = param_leaves(interop.params_from_jax(np_tree(js.params), tcfg, "cpu"))
    bad = total = 0
    for got, w in zip(param_leaves(state.params), want):
        got, w = got.detach().numpy(), w.numpy()
        bad += int(np.sum(np.abs(got - w) > 2e-4 + 0.05 * np.abs(w)))
        total += w.size
    assert bad <= 0.02 * total, f"{bad}/{total} entries differ"
