"""The CLIP rand-pose branch on the CPU, against the JAX package:

  - ``make_torch_clip_loss`` against ``make_jax_clip_loss`` through one fake
    JAX/torch CLIP pair with identical weights (the fixture pattern of
    tests/test_clip_fake.py: no weights can be fetched), and the 224 resize
    against ``jax.image.resize``;
  - one ``make_clip_step`` (render, loss, Adam, EMA) against JAX's from the
    same params and draws, fp32;
  - ``rand_pose_batch`` against JAX's from the same numpy generator;
  - the trainer's schedule (which steps are CLIP steps, where the occupancy
    grid refreshes, one EMA update a step) against JAX's ``train_step_once``
    for rand_pose 0, 2 and -1; its warn-and-continue without a loss; its
    failure where JAX asserts on ``use_objfeat``; ``main_nerf --rand_pose``
    training on without weights, and ``main_dnerf`` announcing the option
    as ignored.
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
from test_torch_model import make_jax_params, start_torch_threads  # noqa: E402
from test_torch_train import _leaves  # noqa: E402

from focnerf_tpu.models import nerf as jnerf  # noqa: E402
from focnerf_tpu.train import state as jstate  # noqa: E402
from focnerf_tpu_torch import interop  # noqa: E402
from focnerf_tpu_torch.models import nerf as tnerf  # noqa: E402
from focnerf_tpu_torch.ops.hashgrid import stochastic_levels  # noqa: E402
from focnerf_tpu_torch.train.state import TrainState, param_leaves  # noqa: E402

start_torch_threads()

MEAN = [0.48145466, 0.4578275, 0.40821073]
STD = [0.26862954, 0.26130258, 0.27577711]
EMB = 8
PROJ = np.random.default_rng(42).normal(size=(3 * 4 * 4, EMB)).astype(np.float32)


def _text_vector(ids):
    return np.arange(EMB, dtype=np.float32) + float(np.sum(ids))


class _Processor:
    """Both packages' CLIPProcessor: token ids are the prompt lengths."""

    class image_processor:  # noqa: N801
        image_mean, image_std = MEAN, STD

    def __call__(self, text=None, return_tensors="np", padding=True):
        ids = np.array([[len(t) for t in text]])
        return {"input_ids": torch.from_numpy(ids) if return_tensors == "pt" else ids}

    @classmethod
    def from_pretrained(cls, name, local_files_only=False):
        assert local_files_only
        return cls()


class _FlaxCLIP:
    """JAX fake: 224 -> 4 x 4 by mean pooling of 56 x 56 blocks, a fixed projection."""

    def get_text_features(self, input_ids=None, **kw):
        return jnp.asarray(_text_vector(np.asarray(input_ids)))[None]

    def get_image_features(self, pixel_values=None):
        x = pixel_values.reshape(1, 3, 4, 56, 4, 56).mean((3, 5))
        return x.reshape(1, -1) @ jnp.asarray(PROJ)

    @classmethod
    def from_pretrained(cls, name, local_files_only=False):
        assert local_files_only
        return cls()


class _TorchCLIP(torch.nn.Module):
    """The torch twin of _FlaxCLIP, with the same projection."""

    def __init__(self):
        super().__init__()
        self.proj = torch.nn.Parameter(torch.from_numpy(PROJ))

    def get_text_features(self, input_ids=None, **kw):
        return torch.from_numpy(_text_vector(input_ids.cpu().numpy()))[None].to(self.proj.device)

    def get_image_features(self, pixel_values=None):
        x = pixel_values.reshape(1, 3, 4, 56, 4, 56).mean((3, 5))
        return x.reshape(1, -1) @ self.proj

    @classmethod
    def from_pretrained(cls, name, local_files_only=False):
        assert local_files_only
        return cls()


@pytest.fixture
def fake_clip(monkeypatch):
    mod = types.ModuleType("transformers")
    mod.FlaxCLIPModel, mod.CLIPModel, mod.CLIPProcessor = _FlaxCLIP, _TorchCLIP, _Processor
    monkeypatch.setitem(sys.modules, "transformers", mod)


def _image(H=16, W=16, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (H, W, 3)).astype(np.float32)


@pytest.mark.parametrize("size", [16, 66, 300])
def test_resize_matches_jax_image_resize(size):
    """66 -> 224 (the default scene's rand-pose image) and 16 -> 224 are
    bilinear upsamples with half-pixel centres: JAX's weights exactly, the
    contraction within fp32 rounding. 300 -> 224 shrinks through JAX's
    antialiasing weights: within 2e-5, because jit computes JAX's shrinking
    weights up to 5.1e-6 away from its own eager formula (measured)."""
    from focnerf_tpu_torch.train.clip_guidance import resize_bilinear

    x = np.random.default_rng(size).uniform(0, 1, (1, 3, size, size)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 3, 224, 224), "bilinear"))
    got = resize_bilinear(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 if size < 224 else 2e-5)


@pytest.fixture
def model_dir(tmp_path):
    """A local model directory: from_pretrained's name for the fakes."""
    path = tmp_path / "clip"
    path.mkdir()
    return str(path)


def test_clip_loss_matches_jax(fake_clip, model_dir):
    from focnerf_tpu.train.clip_guidance import make_jax_clip_loss
    from focnerf_tpu_torch.train.clip_guidance import make_torch_clip_loss

    jloss = make_jax_clip_loss("a red sphere", model_dir)
    tloss = make_torch_clip_loss("a red sphere", model_dir, device="cpu")
    assert jloss is not None and tloss is not None
    img = _image()
    want, jgrad = jax.value_and_grad(jloss)(jnp.asarray(img))
    timg = torch.from_numpy(img).requires_grad_()
    got = tloss(timg)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(timg.grad.numpy(), jgrad, rtol=0, atol=1e-5 * np.abs(jgrad).max())


def test_clip_loss_is_none_without_transformers_or_weights(monkeypatch, fake_clip, model_dir):
    """No weights in the local cache: None before transformers is imported.
    Weights but no transformers: None too."""
    from focnerf_tpu_torch.train.clip_guidance import CLIPLoss, make_torch_clip_loss

    assert make_torch_clip_loss("a sphere", "no-such-org/no-such-clip", device="cpu") is None
    monkeypatch.setitem(sys.modules, "transformers", None)  # import raises
    assert make_torch_clip_loss("a sphere", model_dir, device="cpu") is None
    assert not CLIPLoss("a sphere", model_dir).available


# the CLIP step's model: 4 levels, a 2^8 table (hashed fine levels), 16-wide nets
CLIP_CFG = dict(num_levels=4, base_resolution=4, log2_hashmap_size=8, hidden_dim=16, hidden_dim_color=16,
                bound=1.0, use_objfeat=False, stochastic_corners=1, stochastic_min_size=1)
H = W = 16
T = 16


def _pose_rays(seed=0):
    from focnerf_tpu.core.camera import rand_poses
    from focnerf_tpu.core.rays import get_rays

    pose = rand_poses(np.random.default_rng(seed), 1, radius=2.5)[0]
    rays = get_rays(jnp.asarray(pose), (19.2, 19.2, 8.0, 8.0), H, W)
    return np.asarray(rays["rays_o"]), np.asarray(rays["rays_d"])


def _clip_draws(rng, tcfg):
    """The draws JAX's CLIP step makes from ``rng`` (render_rays: the jitter,
    then the encode's corner draws), in its order and shapes."""
    rng, k_pert = jax.random.split(rng)
    spec = tcfg.encode_spec
    u = jax.random.uniform(jax.random.fold_in(rng, 7), (H * W * T, len(stochastic_levels(spec)), spec.stochastic_k, 3))
    return {"z_noise": torch.from_numpy(np.array(jax.random.uniform(k_pert, (H * W, T)))),
            "u": torch.from_numpy(np.array(u))}


def test_clip_step_matches_jax(fake_clip, model_dir):
    """One ``make_clip_step`` of each package from the same params, rays and
    draws, fp32: the loss within 1e-5 relative, every parameter and EMA
    parameter after Adam within 1e-5 (the step moves a parameter by at most
    lr = 1e-2, so 1e-3 of a step)."""
    from focnerf_tpu.train.clip_guidance import make_jax_clip_loss
    from focnerf_tpu.train.steps import make_clip_step as jmake_clip_step
    from focnerf_tpu_torch.train.clip_guidance import make_torch_clip_loss
    from focnerf_tpu_torch.train.steps import make_clip_step

    jcfg = jnerf.NeRFConfig(**CLIP_CFG, compute_dtype=jnp.float32)
    tcfg = tnerf.NeRFConfig(**CLIP_CFG, compute_dtype=torch.float32)
    params = make_jax_params(jcfg, grid_scale=0.5)
    opt = jstate.make_optimizer(lr=1e-2, iters=100)
    js = jstate.create_train_state(jax.random.key(0), jcfg, opt, params=jax.tree.map(jnp.asarray, params))
    o, d = (a.copy() for a in _pose_rays())
    rng = jax.random.key(1)
    jstep = jmake_clip_step(jcfg, opt, make_jax_clip_loss("a sphere", model_dir), H=H, W=W, num_steps=T)
    js, jm = jstep(js, jnp.asarray(o), jnp.asarray(d), rng)

    ts = TrainState(interop.params_from_jax(params, tcfg, "cpu"), lr=1e-2, iters=100)
    step = make_clip_step(tcfg, make_torch_clip_loss("a sphere", model_dir, device="cpu"), H=H, W=W, num_steps=T)
    tm = step(ts, torch.from_numpy(o), torch.from_numpy(d), _clip_draws(rng, tcfg))
    assert np.isfinite(float(tm["loss"])) and ts.step == int(js.step) == 1 and ts.ema_count == 1
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    moved = 0
    for got, want, start in zip(_leaves(ts.params), _leaves(js.params), _leaves(params)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        moved += int((np.abs(want - start) > 1e-3).sum())
    for got, want in zip(_leaves(ts.ema_params), _leaves(js.ema_params)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert moved > 100  # the guidance gradient reached the field


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_synthetic_scene(str(tmp_path_factory.mktemp("clip") / "scene"), n_train=2, n_val=1, H=32, W=32)


def test_rand_pose_batch_matches_jax(scene):
    from focnerf_tpu.data.provider import DatasetOptions as JOptions
    from focnerf_tpu.data.provider import NeRFDataset as JDataset
    from focnerf_tpu_torch.data.provider import DatasetOptions, NeRFDataset

    kw = dict(path=scene, scale=1.0, num_rays=64, radius=2.5)
    jds = JDataset(JOptions(**kw), split="train")
    tds = NeRFDataset(DatasetOptions(**kw), split="train", device="cpu")
    jrng, trng = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(2):
        want = jds.rand_pose_batch(jax.random.key(0), jrng)
        got = tds.rand_pose_batch(trng)
        assert (got["H"], got["W"]) == (want["H"], want["W"]) == (8, 8)  # s = int(sqrt(32 * 32 / 64)) = 4
        np.testing.assert_allclose(got["rays_o"].numpy(), np.asarray(want["rays_o"]), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got["rays_d"].numpy(), np.asarray(want["rays_d"]), rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------- the trainer
TRAIN_CFG = dict(num_levels=2, base_resolution=4, log2_hashmap_size=8, hidden_dim=16, hidden_dim_color=16,
                 bound=1.0, use_objfeat=False)
STEPS = 20
TRAINER_KW = dict(num_steps=16, use_occupancy=True, train_slab=16, max_steps=64, use_checkpoint="scratch",
                  seed=3)


def _stub_clip(img):
    return (img - 0.5).square().mean()


def _jax_schedule(tmp_path, ds, rand_pose, use_objfeat=False):
    """JAX's train_step_once schedule for STEPS steps -> (CLIP steps,
    occupancy refresh steps, rand poses). Its compiled functions are
    replaced by recorders: the schedule is the trainer's Python."""
    from focnerf_tpu.train.trainer import Trainer as JTrainer

    jcfg = jnerf.NeRFConfig(**dict(TRAIN_CFG, use_objfeat=use_objfeat), compute_dtype=jnp.float32)
    tr = JTrainer("t", jcfg, workspace=str(tmp_path / "j"), use_tensorboard=False, rand_pose=rand_pose,
                  clip_loss_fn=_stub_clip, **TRAINER_KW)
    clip, occ, poses = [], [], []

    def clip_step(state, rays_o, rays_d, rng):
        clip.append(tr.global_step)
        return state._replace(step=state.step + 1, ema_count=state.ema_count + 1), {"loss": 0.0}

    def occ_step(state, batch, bits, k):
        return state._replace(step=state.step + 1, ema_count=state.ema_count + 1), {"loss": 0.0}

    def occ_update(occupancy, params, rng):
        occ.append(tr.global_step)
        return occupancy

    class DS:
        def train_batch(self, rng):
            return {}

        def rand_pose_batch(self, rng, rng_np):
            out = ds.rand_pose_batch(rng_np)  # the port's dataset, fed JAX's generator
            poses.append(out["rays_o"][0].numpy())
            return out

    tr._clip_step_fn, tr._occ_update_jit = clip_step, occ_update
    tr._occ_step = lambda slab: occ_step
    for _ in range(STEPS):
        tr.train_step_once(DS())
    assert int(tr.state.step) == int(tr.state.ema_count) == STEPS
    return clip, occ, poses, tr


@pytest.mark.parametrize("rand_pose", [0, 2, -1])
def test_trainer_schedule_matches_jax(scene, tmp_path, monkeypatch, rand_pose):
    """The port trains STEPS real steps through ``train`` (rand_pose 0 and 2
    with a stand-in loss): the CLIP steps, the occupancy refreshes and the
    rand poses are JAX's ``train_step_once``'s, and every step of either
    kind is one Adam and one EMA update."""
    from focnerf_tpu_torch.data.provider import DatasetOptions, NeRFDataset
    from focnerf_tpu_torch.train import trainer as ttrainer

    ds = NeRFDataset(DatasetOptions(path=scene, scale=1.0, num_rays=64, radius=2.5), split="train", device="cpu")
    want_clip, want_occ, want_poses, _ = _jax_schedule(tmp_path, ds, rand_pose)
    occ, update = [], ttrainer.update_occupancy

    def recorded(*a, **k):
        occ.append(tr.global_step)
        return update(*a, **k)

    monkeypatch.setattr(ttrainer, "update_occupancy", recorded)
    poses, rand_pose_batch = [], ds.rand_pose_batch

    def recorded_batch(rng_np):
        out = rand_pose_batch(rng_np)
        poses.append(out["rays_o"][0].numpy())
        return out

    ds.rand_pose_batch = recorded_batch
    tcfg = tnerf.NeRFConfig(**TRAIN_CFG, compute_dtype=torch.float32)
    tr = ttrainer.Trainer("t", tcfg, workspace=str(tmp_path / "t"), rand_pose=rand_pose, clip_loss_fn=_stub_clip,
                          device="cpu", **TRAINER_KW)
    grid0 = tr.state.params["grid"].detach().clone()
    tr.train(ds, None, max_epochs=1, steps_per_epoch=STEPS)
    assert tr.clip_steps == want_clip and occ == want_occ
    assert len(want_clip) == {0: STEPS, 2: STEPS // 3, -1: 0}[rand_pose]
    np.testing.assert_array_equal(np.array(poses), np.array(want_poses))
    assert tr.global_step == tr.state.step == tr.state.ema_count == STEPS
    assert np.isfinite(tr.step_losses).all() and len(tr.step_losses) == STEPS
    assert not torch.equal(tr.state.params["grid"], grid0)


def test_without_a_loss_it_warns_once_and_trains_on(scene, tmp_path):
    """clip_text "" and no loss: JAX's warning, once, then ordinary steps."""
    from focnerf_tpu.train.trainer import Trainer as JTrainer
    from focnerf_tpu_torch.data.provider import DatasetOptions, NeRFDataset
    from focnerf_tpu_torch.train.trainer import Trainer

    jcfg = jnerf.NeRFConfig(**TRAIN_CFG, compute_dtype=jnp.float32)
    jtr = JTrainer("t", jcfg, workspace=str(tmp_path / "j"), use_tensorboard=False, rand_pose=0, **TRAINER_KW)
    assert jtr._maybe_clip_step(None) is None and jtr.rand_pose == -1
    tcfg = tnerf.NeRFConfig(**TRAIN_CFG, compute_dtype=torch.float32)
    tr = Trainer("t", tcfg, workspace=str(tmp_path / "t"), rand_pose=0, device="cpu", **TRAINER_KW)
    ds = NeRFDataset(DatasetOptions(path=scene, scale=1.0, num_rays=64), split="train", device="cpu")
    tr.train(ds, None, max_epochs=1, steps_per_epoch=3)
    assert tr.rand_pose == -1 and tr.clip_steps == [] and tr.global_step == 3

    def warnings(path):
        with open(path) as f:
            return [line for line in f if line.startswith("[WARN]")]

    want = warnings(jtr.log_path)
    assert len(want) == 1 and "rand-pose branch" in want[0]
    assert warnings(tr.log_path) == want


@pytest.mark.parametrize("rand_pose", [0, 2])
def test_objfeat_config_fails_where_jax_asserts(scene, tmp_path, rand_pose):
    """JAX's CLIP step renders without an object feature and asserts when the
    config conditions on one; the port raises the same message on the same
    (first scheduled) step. JAX is run where it needs no compiled step."""
    from focnerf_tpu_torch.data.provider import DatasetOptions, NeRFDataset
    from focnerf_tpu_torch.train.trainer import Trainer

    ds = NeRFDataset(DatasetOptions(path=scene, scale=1.0, num_rays=64), split="train", device="cpu")
    msg = "cfg.use_objfeat=True requires obj_feat"
    if rand_pose == 0:
        from focnerf_tpu.train.trainer import Trainer as JTrainer

        jcfg = jnerf.NeRFConfig(**dict(TRAIN_CFG, use_objfeat=True), compute_dtype=jnp.float32)
        jtr = JTrainer("t", jcfg, workspace=str(tmp_path / "j"), use_tensorboard=False, rand_pose=0,
                       clip_loss_fn=_stub_clip, **TRAINER_KW)

        class DS:
            def rand_pose_batch(self, rng, rng_np):
                out = ds.rand_pose_batch(rng_np)
                return {k: jnp.asarray(v.numpy()) if torch.is_tensor(v) else v for k, v in out.items()}

        with pytest.raises(AssertionError, match=msg):
            jtr.train_step_once(DS())
        assert jtr.global_step == 0
    train_batch = ds.train_batch  # the ordinary steps get the object feature they need
    ds.train_batch = lambda g, draws=None: dict(train_batch(g, draws), obj_feat=torch.zeros(144))
    tcfg = tnerf.NeRFConfig(**dict(TRAIN_CFG, use_objfeat=True), compute_dtype=torch.float32)
    tr = Trainer("t", tcfg, workspace=str(tmp_path / "t"), rand_pose=rand_pose, clip_loss_fn=_stub_clip,
                 device="cpu", **TRAINER_KW)
    with pytest.raises(ValueError, match=msg):
        tr.train(ds, None, max_epochs=1, steps_per_epoch=STEPS)
    assert tr.global_step == rand_pose  # the steps before the first CLIP step ran


def test_main_dnerf_announces_rand_pose_ignored(capsys):
    from focnerf_tpu_torch.apps.main_dnerf import warn_ignored
    from focnerf_tpu_torch.config import parse_options

    warn_ignored(parse_options(["s", "--rand_pose", "0"]))
    lines = [line for line in capsys.readouterr().out.splitlines() if "rand_pose" in line]
    assert len(lines) == 1 and lines[0].startswith("[main_dnerf] --rand_pose 0 is ignored: ")
    warn_ignored(parse_options(["s"]))
    assert "rand_pose" not in capsys.readouterr().out

