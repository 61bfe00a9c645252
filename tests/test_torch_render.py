"""The whole serving slice (e) on the CPU: the port's ``render_image`` and
``main_nerf --test -O`` held against the JAX package on the same params and
occupancy grid, with the JAX checkpoint converted by
``tools/jax_ckpt_to_torch.py``."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))
from helpers import make_synthetic_scene  # noqa: E402
from test_torch_model import SMALL, make_jax_params  # noqa: E402

from focnerf_tpu.models import nerf as jnerf  # noqa: E402
from focnerf_tpu.ops.occupancy import OccupancyState as JOccupancyState  # noqa: E402
from focnerf_tpu.render.renderer import render_image as jrender_image  # noqa: E402
from focnerf_tpu_torch import interop  # noqa: E402
from focnerf_tpu_torch.data.png import read_image  # noqa: E402
from focnerf_tpu_torch.models import nerf as tnerf  # noqa: E402
from focnerf_tpu_torch.ops.composite import composite_rays_fused  # noqa: E402
from focnerf_tpu_torch.render.renderer import render_image as trender_image  # noqa: E402


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_synthetic_scene(str(tmp_path_factory.mktemp("scene")), n_train=3, n_val=2)


def sphere_density_grid(bound: float, radius: float = 0.7, gs: int = 128) -> np.ndarray:
    """[CAS, gs^3] density: 20 in cells whose centre lies within ``radius``."""
    cas = 1 + int(np.ceil(np.log2(max(bound, 1.0))))
    c = (np.arange(gs, dtype=np.float32) + 0.5) / gs * 2.0 - 1.0
    r2 = c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2
    grid = np.zeros((cas, gs**3), np.float32)
    for k in range(cas):
        scale = min(2.0**k, bound)
        grid[k] = np.where(r2.reshape(-1) * scale**2 < radius**2, 20.0, 0.0)
    return grid


def visible_params(jcfg, seed=0):
    """JAX params whose sigma is large enough to render a visible object."""
    p = make_jax_params(jcfg, seed)
    p["sigma_net"][-1][:, 0] *= 4.0
    return p


def _view(scene):
    from focnerf_tpu_torch.data.provider import DatasetOptions, NeRFDataset

    ds = NeRFDataset(DatasetOptions(path=scene, scale=1.0), split="test", device="cpu")
    return ds.poses[0], ds.intrinsics, ds.H, ds.W


@pytest.mark.parametrize("path", ["occupancy", "uniform"])
def test_render_image_matches_jax(scene, path):
    jcfg = jnerf.NeRFConfig(**SMALL, compute_dtype=jnp.float32)
    tcfg = tnerf.NeRFConfig(**SMALL, compute_dtype=torch.float32)
    jp = visible_params(jcfg)
    tp = interop.params_from_jax(jp, tcfg, "cpu")
    pose, intr, H, W = _view(scene)
    feat = np.random.default_rng(0).normal(size=144).astype(np.float32)
    kw = dict(max_ray_batch=512, bg_color=1.0, min_near=0.2)
    if path == "occupancy":
        bits = sphere_density_grid(1.0) > 10.0
        kw.update(dt_gamma=1 / 128, max_steps=1024, slab=128)
        jkw = dict(kw, occ_bits=jnp.asarray(bits))
        tkw = dict(kw, occ_bits=torch.from_numpy(bits))
    else:
        jkw = tkw = dict(kw, num_steps=64)
    jimg, jdepth = jrender_image(jp, jcfg, jnp.asarray(pose), intr, H, W,
                                 obj_feat=jnp.asarray(feat), **jkw)
    timg, tdepth = trender_image(tp, tcfg, pose, intr, H, W, obj_feat=feat, **tkw)
    jimg, jdepth = np.asarray(jimg), np.asarray(jdepth)
    assert timg.shape == (H, W, 3) and np.isfinite(timg.numpy()).all()
    assert 0.05 < float((1.0 - jimg).mean()) < 0.95  # a visible object, not blank
    # fp32 on both sides: sums over up to 128 samples in another order and
    # libm-vs-XLA exp/pow; a march flip at a cell boundary would show here
    # as a larger error on one pixel, and none is allowed at this size
    np.testing.assert_allclose(timg.numpy(), jimg, atol=2e-5)
    np.testing.assert_allclose(tdepth.numpy(), jdepth, atol=2e-5)


@pytest.mark.parametrize("path", ["occupancy", "uniform"])
def test_render_image_composites_through_the_fused_wrapper(scene, monkeypatch, path):
    """Both render paths composite every chunk through ``composite_rays_fused``,
    the wrapper that launches the kernel on a CUDA tensor; neither calls the
    plain compositor itself."""
    from focnerf_tpu_torch.render import renderer

    assert not hasattr(renderer, "composite_rays")
    calls = []

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return composite_rays_fused(*args, **kwargs)

    monkeypatch.setattr(renderer, "composite_rays_fused", counted)
    tcfg = tnerf.NeRFConfig(**SMALL, compute_dtype=torch.float32)
    tp = tnerf.init_nerf_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    pose, intr, H, W = _view(scene)
    kw = dict(max_ray_batch=256, bg_color=1.0)
    if path == "occupancy":
        kw.update(occ_bits=torch.from_numpy(sphere_density_grid(1.0) > 10.0), slab=32)
    else:
        kw.update(num_steps=16)
    img, _ = trender_image(tp, tcfg, pose, intr, H, W, obj_feat=np.ones(144, np.float32), **kw)
    assert len(calls) == -(-H * W // 256) and all(s[0] == 256 for s in calls)
    assert img.shape == (H, W, 3) and torch.isfinite(img).all()


def _jax_workspace(scene, ws, argv):
    """A JAX workspace as ``main_nerf`` training would leave it: an orbax
    checkpoint (EMA params distinct from params), the occupancy grid and
    obj_feats/background.npz."""
    from focnerf_tpu.config import parse_options
    from focnerf_tpu.data.feats import save_obj_feats
    from focnerf_tpu.train.checkpoints import CheckpointManager, save_model_config
    from focnerf_tpu.train.state import create_train_state, make_optimizer

    jcfg = parse_options(argv).nerf_config()
    ema = jax.tree.map(jnp.asarray, visible_params(jcfg, seed=1))
    raw = jax.tree.map(jnp.asarray, visible_params(jcfg, seed=2))  # test must not render these
    state = create_train_state(jax.random.key(0), jcfg, make_optimizer(), params=raw)
    state = state._replace(ema_params=ema, step=jnp.asarray(7, jnp.int32))
    grid = sphere_density_grid(jcfg.bound)
    occ = JOccupancyState(jnp.asarray(grid), jnp.asarray(grid.mean()), jnp.asarray(3, jnp.int32))
    ckpt = os.path.join(f"{ws}_background", "checkpoints")
    mgr = CheckpointManager(ckpt)
    mgr.save(state, occ)
    mgr.close()
    save_model_config(ckpt, jcfg)
    rng = np.random.default_rng(5)
    save_obj_feats(os.path.join(ws, "obj_feats", "background.npz"),
                   rng.normal(size=(3, 144)).astype(np.float32),
                   rng.normal(size=(3, 4, 4)).astype(np.float32))
    return ckpt


def test_main_test_mode_matches_jax(scene, tmp_path):
    """``main_nerf --test -O`` end to end: JAX checkpoint -> converter -> the
    port's CLI on the CPU, against the JAX CLI on the same checkpoint."""
    import shutil

    from jax_ckpt_to_torch import convert

    from focnerf_tpu.apps import main_nerf as jmain
    from focnerf_tpu_torch.apps import main_nerf as tmain
    from focnerf_tpu_torch.train.checkpoints import CheckpointManager

    common = ["--test", "-O", "--disable_yolo", "--scale", "1.0", "--bound", "1.0",
              "--grid_levels", "4", "--max_ray_batch", "1024"]
    wsj, wst = str(tmp_path / "wsj"), str(tmp_path / "wst")
    ckpt = _jax_workspace(scene, wsj, [scene, "--workspace", wsj] + common)
    assert convert(ckpt, os.path.join(f"{wst}_background", "checkpoints")) == 7
    assert CheckpointManager(os.path.join(f"{wst}_background", "checkpoints")).steps() == [7]
    shutil.copytree(os.path.join(wsj, "obj_feats"), os.path.join(wst, "obj_feats"))

    composite_rays_fused.launches = 0
    tmain.main([scene, "--workspace", wst] + common, device="cpu")
    assert composite_rays_fused.launches == 0  # CPU run: the plain compositor only
    jmain.main([scene, "--workspace", wsj] + common)

    for v in range(2):
        name = f"ngp_{v:04d}.png"
        got = read_image(os.path.join(f"{wst}_background", "results", name)).astype(int)
        want = read_image(os.path.join(f"{wsj}_background", "results", name)).astype(int)
        assert got.shape == want.shape == (32, 32, 3)
        assert (want < 250).mean() > 0.05  # the object covers part of the view
        # bf16 (-O) on both sides: the same bf16-rounded operands with fp32
        # sums; PNGs quantize to 1/255, so a value near a rounding edge may
        # land one level apart
        assert np.abs(got - want).max() <= 1, np.abs(got - want).max()
        assert os.path.exists(os.path.join(f"{wst}_background", "results", f"ngp_{v:04d}_depth.png"))


def test_main_needs_cuda_or_an_explicit_cpu(scene, tmp_path):
    from focnerf_tpu_torch.apps import main_nerf as tmain
    from focnerf_tpu_torch.render.iterative import render_rays_iterative

    argv = [scene, "--workspace", str(tmp_path / "ws"), "--disable_yolo"]
    # -O training with a val split and the default eval_renderer ("iter")
    # runs on an explicit CPU and evaluates through the iterative renderer
    render_rays_iterative.rounds = 0
    # no mesh export: at the default 256^3 it took most of the test's time,
    # and nothing here reads the mesh
    (tr,) = tmain.main(argv + ["-O", "--scale", "1.0", "--bound", "1.0", "--grid_levels", "4",
                               "--num_rays", "256", "--iters", "3", "--mesh_res", "0"], device="cpu")
    assert tr.eval_renderer == "iter" and tr.global_step == 3 and tr.last_eval_step == 3
    assert render_rays_iterative.rounds > 0 and np.isfinite(tr.last_eval_results["PSNR"])
    assert os.path.exists(os.path.join(str(tmp_path / "ws") + "_background", "checkpoints",
                                       "ckpt_00000003.pt"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmain.main(argv + ["--test"])
