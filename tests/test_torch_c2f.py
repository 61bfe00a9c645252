"""``-O2``'s levers and the TV term on the CPU, against the JAX package:

  - ``HashGridSpec.truncate`` and ``hashgrid_encode_c2f`` (exact and
    stochastic, output and table gradient);
  - the level-subset table gradient (``grad_levels``) against JAX's
    sort-mode backward, with every other level's rows exactly 0;
  - ``hashgrid_tv_loss``, its value and its gradient;
  - the trainer's ``_phase_cfg`` over a run with two c2f stages and P = 2,
    and four trainer steps that cross both stage boundaries and both
    phases, fed JAX's batches and draws;
  - ``-O2``'s option overrides, as JAX's.
"""

import dataclasses
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
from focnerf_tpu.ops import hashgrid as jhg  # noqa: E402
from focnerf_tpu_torch import interop  # noqa: E402
from focnerf_tpu_torch.models import nerf as tnerf  # noqa: E402
from focnerf_tpu_torch.ops import hashgrid as thg  # noqa: E402

start_torch_threads()

# 6 levels, the finest three hashed into 2^10 rows
SPEC_KW = dict(num_levels=6, level_dim=2, base_resolution=4, log2_hashmap_size=10, desired_resolution=64)


def _specs(stochastic: bool, **kw):
    j = jhg.HashGridSpec.create(**SPEC_KW)
    t = thg.HashGridSpec.create(**SPEC_KW)
    if stochastic:
        j = dataclasses.replace(j, stochastic_k=1, stochastic_min_size=1)
        t = dataclasses.replace(t, stochastic_k=1, stochastic_min_size=1)
    return dataclasses.replace(j, **kw), dataclasses.replace(t, **kw)


def _inputs(spec, n=257, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1, 1, (spec.table_rows, spec.level_dim)).astype(np.float32)
    x = rng.uniform(-0.02, 1.02, (n, 3)).astype(np.float32)  # a few outside [0, 1]
    return table, x


def _weights(n_out):
    return np.sin(np.arange(n_out, dtype=np.float32)) + 1.5


def test_truncate_matches_jax():
    full_j = jnerf.NeRFConfig(grad_levels=(1, 3, 5, 14)).grid_spec
    full_t = tnerf.NeRFConfig(grad_levels=(1, 3, 5, 14)).grid_spec
    for active in (1, 8, 12, 16):
        j, t = full_j.truncate(active), full_t.truncate(active)
        for f in ("num_levels", "resolutions", "offsets", "hashed", "grad_levels", "table_rows", "output_dim"):
            assert getattr(t, f) == getattr(j, f), (active, f)
    for bad in (0, 17):
        with pytest.raises(ValueError):
            full_t.truncate(bad)


# (stochastic, active levels, grad_levels): exact and K = 1 corners, a
# truncated stage, a level subset, both at once, and a subset with no level
# in the stage (``truncate`` then drops it, as JAX's: every active level
# trains)
CASES = [
    (False, 3, None), (True, 3, None), (False, 0, (0, 2, 5)), (True, 0, (1, 3, 4)),
    (True, 4, (0, 2, 5)), (False, 2, (4, 5)),
]


@pytest.mark.parametrize("stochastic,active,levels", CASES)
def test_encode_c2f_and_level_subset_grad_match_jax(stochastic, active, levels):
    """Output and table gradient of sum(w * encode): fp32, the same gathers
    and products, summed in another order (limit 1e-5 relative; measured
    ~1e-7). The rows of levels without gradient are exactly 0 on both."""
    jspec, tspec = _specs(stochastic, grad_levels=levels)
    table, x = _inputs(jspec)
    w = _weights(jspec.output_dim)
    key = jax.random.key(3) if stochastic else None

    def jloss(t):
        return jnp.sum(jhg.hashgrid_encode_c2f(t, jnp.asarray(x), jspec, active, rng=key) * w)

    jout = np.asarray(jhg.hashgrid_encode_c2f(jnp.asarray(table), jnp.asarray(x), jspec, active, rng=key))
    jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(table)))

    u = None
    if stochastic:  # JAX's draws: the truncated spec's stochastic levels
        enc = tspec.truncate(active) if 0 < active < tspec.num_levels else tspec
        u = torch.from_numpy(np.array(jax.random.uniform(
            key, (x.shape[0], len(thg.stochastic_levels(enc)), 1, 3))))
    tt = torch.from_numpy(table).requires_grad_()
    tout = thg.hashgrid_encode_c2f(tt, torch.from_numpy(x), tspec, active, u)
    (tout * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), jout, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tt.grad.numpy(), jgrad, rtol=1e-5, atol=1e-5)

    live = set(range(active or tspec.num_levels)) & set(levels if levels is not None else range(6))
    live = live or set(range(active))
    for lvl in range(tspec.num_levels):
        blk = tt.grad.numpy()[tspec.offsets[lvl]:tspec.offsets[lvl + 1]]
        if lvl in live:
            assert np.abs(blk).max() > 0, lvl
        else:
            assert (blk == 0).all() and (jgrad[tspec.offsets[lvl]:tspec.offsets[lvl + 1]] == 0).all(), lvl
    if active:  # the fine levels' feature slots are zero
        assert (tout.detach().numpy()[:, active * 2:] == 0).all()


def test_tv_loss_and_gradient_match_jax():
    """fp32: the same gathers; sums of 8192 terms in another order (limit
    1e-5 relative on the value, 1e-5 of the largest on the gradient)."""
    jspec, tspec = _specs(False)
    table, _ = _inputs(jspec)
    x = np.random.default_rng(1).uniform(0, 1, (8192, 3)).astype(np.float32)
    jval, jgrad = jax.value_and_grad(lambda t: jhg.hashgrid_tv_loss(t, jnp.asarray(x), jspec))(jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_()
    tval = thg.hashgrid_tv_loss(tt, torch.from_numpy(x), tspec)
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-5)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(tt.grad.numpy(), jgrad, rtol=0, atol=1e-5 * np.abs(jgrad).max())


def test_O2_keeps_jax_overrides():
    """``-O2`` turns explicitly disabled levers back on, in both packages:
    ``--grad_level_phases 0`` becomes 2 and ``--c2f ""`` the default
    schedule; below 12 levels c2f stays off."""
    from focnerf_tpu.config import parse_options as jparse
    from focnerf_tpu_torch.config import parse_options as tparse

    for argv in (["s", "-O2"], ["s", "-O2", "--grad_level_phases", "0", "--c2f", ""],
                 ["s", "-O2", "--grid_levels", "8"], ["s", "-O2", "--c2f", "0.5:4", "--grad_level_phases", "3"]):
        j, t = jparse(argv), tparse(argv)
        got = (t.grad_level_phases, t.c2f, t.cuda_ray, t.stochastic_corners, t.skip_march)
        assert got == (j.grad_level_phases, j.c2f, j.cuda_ray, j.stochastic_corners, j.skip_march), argv
    assert tparse(["s", "-O2", "--grad_level_phases", "0", "--c2f", ""]).c2f == "0.3:8,0.6:12"
    assert tparse(["s", "-O2", "--grad_level_phases", "0"]).grad_level_phases == 2
    assert tparse(["s", "-O2", "--grid_levels", "8"]).c2f == ""


# ------------------------------------------------------------------ trainer
C2F, P, ITERS = "2:2,3:3", 2, 8  # steps 0-1 on 2 levels, step 2 on 3, then all 4


def _trainers(tmp_path, **kw):
    from focnerf_tpu.train.trainer import Trainer as JTrainer
    from focnerf_tpu_torch.train.trainer import Trainer

    common = {**dict(c2f=C2F, grad_level_phases=P, iters=ITERS, use_occupancy=True, skip_march=True,
                     use_checkpoint="scratch", train_slab=32), **kw}
    jcfg = jnerf.NeRFConfig(**dict(SMALL, use_objfeat=False), stochastic_corners=1, stochastic_min_size=1,
                            compute_dtype=jnp.float32)
    tcfg = tnerf.NeRFConfig(**dict(SMALL, use_objfeat=False), stochastic_corners=1, stochastic_min_size=1,
                            compute_dtype=torch.float32)
    jtr = JTrainer("ngp", jcfg, workspace=str(tmp_path / "j"), use_tensorboard=False, **common)
    ttr = Trainer("ngp", tcfg, workspace=str(tmp_path / "t"), device="cpu", **common)
    return jtr, ttr


def test_phase_cfg_sequence_matches_jax(tmp_path):
    jtr, ttr = _trainers(tmp_path)
    assert ttr.c2f_stages == jtr._c2f_stages == [(2, 2), (3, 3)]
    seen = []
    for step in range(ITERS):
        jtr.global_step = ttr.global_step = step
        (jc, jkey), (tc, tkey) = jtr._phase_cfg(), ttr._phase_cfg()
        assert tkey == jkey and tc.active_levels == jc.active_levels, step
        assert tc.grad_levels == jc.grad_levels, step
        assert tc.encode_spec.num_levels == (jc.active_levels or jc.num_levels)
        seen.append((tkey, tc.grad_levels))
    assert seen[:4] == [((0, 2), (0,)), ((1, 2), (1,)), ((0, 3), (0, 2)), ((1, 0), (1, 3))]
    for bad, match in ((dict(c2f="0.5:9"), "outside"), (dict(c2f="", use_occupancy=False), "occupancy"),
                       (dict(grad_level_phases=0, use_occupancy=False), "occupancy")):
        with pytest.raises(ValueError, match=match):
            _trainers(tmp_path, **bad)


def test_trainer_steps_across_stages_and_phases_match_jax(tmp_path, monkeypatch):
    """Four steps of each trainer from the same params and grid, the port
    fed JAX's batches and the draws JAX's step makes from its key (sized by
    each stage's truncated spec): steps 0-1 on 2 levels (phases 0, 1), step
    2 on 3 levels, step 3 on all 4. Losses fp32 within 1e-4 relative (the
    same draws and march, sums in another order; the params they see come
    from Adam steps with eps 1e-15)."""
    from focnerf_tpu.data.provider import DatasetOptions as JDatasetOptions
    from focnerf_tpu.data.provider import NeRFDataset as JNeRFDataset
    from focnerf_tpu.ops.occupancy import OccupancyState
    from focnerf_tpu_torch.train import trainer as ttrainer

    scene = make_synthetic_scene(str(tmp_path / "scene"), n_train=3, n_val=1)
    jtr, ttr = _trainers(tmp_path)
    params = make_jax_params(jtr.cfg, grid_scale=0.5)
    params["sigma_net"][-1][:, 0] *= 4.0  # a visible object
    jtr.state = jtr.state._replace(params=jax.tree.map(jnp.asarray, params),
                                   ema_params=jax.tree.map(jnp.asarray, params))
    ttr.state.load_state_dict({"params": interop.params_from_jax(params, ttr.cfg, "cpu"),
                               "ema_params": interop.params_from_jax(params, ttr.cfg, "cpu")}, weights_only=True)
    grid = sphere_density_grid(1.0)
    occ = {"density_grid": grid, "mean_density": np.float32(grid.mean()), "iter_density": np.int32(20)}
    jtr.occupancy = OccupancyState(*(jnp.asarray(v) for v in occ.values()))
    ttr.occupancy = interop.occupancy_from_jax(occ, 1.0, "cpu")
    for tr in (jtr, ttr):  # the same fixed grid on both sides
        tr._maybe_update_occupancy = lambda: None

    record = []
    orig = jtr._occ_step

    def occ_step(slab):
        fn = orig(slab)

        def run(state, batch, bits, k):
            record.append((jax.tree.map(np.asarray, batch), k))
            return fn(state, batch, bits, k)
        return run

    jtr._occ_step = occ_step
    ds = JNeRFDataset(JDatasetOptions(path=scene, scale=1.0, num_rays=64), split="train")
    jlosses = [jtr.train_step_once(ds) for _ in range(4)]

    class Batches:  # JAX's batches, in order
        it = iter(record)

        def train_batch(self, generator):
            return {k: torch.from_numpy(np.array(v)) for k, v in next(self.it)[0].items()}

    keys = iter(k for _, k in record)

    def jax_draws(generator, cfg, n, slab, device, tv=False):
        k_bg, k_perturb = jax.random.split(next(keys))
        spec = cfg.encode_spec
        to = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
        return {"bg": to(jax.random.uniform(k_bg, (n, 3))), "noise": to(jax.random.uniform(k_perturb, (n,))),
                "u": to(jax.random.uniform(jax.random.fold_in(k_perturb, 7),
                                           (n * slab, len(thg.stochastic_levels(spec)), 1, 3)))}

    monkeypatch.setattr(ttrainer, "step_draws", jax_draws)
    batches = Batches()
    tlosses = [float(ttr.train_step_once(batches)["loss"]) for _ in range(4)]
    assert ttr.global_step == jtr.global_step == 4
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    # the fourth level's rows moved only on step 3 (full encode, phase 1)
    # and level 2's on step 2; level 0 trained on steps 0 and 2
    g0 = ttr.state.params["grid"].detach().numpy()
    spec = ttr.cfg.grid_spec
    moved = [np.abs(g0[spec.offsets[lv]:spec.offsets[lv + 1]] - params["grid"][spec.offsets[lv]:spec.offsets[lv + 1]]).max()
             for lv in range(4)]
    assert min(moved) > 0
    np.testing.assert_allclose(g0, np.asarray(jtr.state.params["grid"]), rtol=0, atol=1e-4 * 1e-2 * 4)


def test_empty_level_subset_gets_zero_gradient():
    """A gradient phase with no level (P above the level count, no c2f):
    the forward is the full encode's and the table gradient is 0 (JAX's sort
    backward raises on the empty column list there)."""
    _, tspec = _specs(False)
    table, x = _inputs(tspec)
    tt = torch.from_numpy(table).requires_grad_()
    out = thg.hashgrid_encode(tt, torch.from_numpy(x), dataclasses.replace(tspec, grad_levels=()))
    out.sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(),
                                  thg.hashgrid_encode(torch.from_numpy(table), torch.from_numpy(x), tspec).numpy())
    assert tt.grad.shape == table.shape and not tt.grad.any()
