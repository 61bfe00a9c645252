"""The composition and editing CLIs (apps/combined.py, apps/editable.py) and
what they load on the CPU: object features, meters, object checkpoints, and
both CLIs end to end against the JAX package's on the same two objects (JAX
workspaces converted by ``tools/jax_ckpt_to_torch.py``)."""

import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))
from helpers import make_synthetic_scene  # noqa: E402
from test_torch_render import sphere_density_grid, visible_params  # noqa: E402

from focnerf_tpu.apps import combined as jcombined  # noqa: E402
from focnerf_tpu.apps import editable as jeditable  # noqa: E402
from focnerf_tpu.config import parse_options as jparse  # noqa: E402
from focnerf_tpu.data import feats as jfeats  # noqa: E402
from focnerf_tpu.render import baked as jb  # noqa: E402
from focnerf_tpu.train import checkpoints as jckpt  # noqa: E402
from focnerf_tpu.train import meters as jmeters  # noqa: E402
from focnerf_tpu_torch.apps import combined as tcombined  # noqa: E402
from focnerf_tpu_torch.apps import editable as teditable  # noqa: E402
from focnerf_tpu_torch.config import parse_options as tparse  # noqa: E402
from focnerf_tpu_torch.data import feats as tfeats  # noqa: E402
from focnerf_tpu_torch.data.png import read_image  # noqa: E402
from focnerf_tpu_torch.ops.composite import composite_rays_fused  # noqa: E402
from focnerf_tpu_torch.render import baked as tb  # noqa: E402
from focnerf_tpu_torch.train import checkpoints as tckpt  # noqa: E402
from focnerf_tpu_torch.train import meters as tmeters  # noqa: E402

OBJS = ("a", "b")
MODEL = ["-O", "--scale", "1.0", "--bound", "1.0", "--grid_levels", "4", "--max_ray_batch", "1024"]


def _sidecars(root, rng, n_views=3):
    paths = []
    for obj in OBJS:
        paths.append(os.path.join(root, "obj_feats", f"{obj}.npz"))
        jfeats.save_obj_feats(paths[-1], rng.normal(size=(n_views, 144)).astype(np.float32),
                              rng.normal(size=(n_views, 4, 4)).astype(np.float32))
    return paths


def test_feature_functions_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    paths = _sidecars(str(tmp_path), rng)
    test_poses = rng.normal(size=(4, 4, 4)).astype(np.float32)
    d = tfeats.load_obj_feats(paths[0])
    np.testing.assert_array_equal(tfeats._pose_distance(test_poses[0], d["poses"]),
                                  jfeats._pose_distance(test_poses[0], d["poses"]))
    np.testing.assert_array_equal(tfeats.calculate_avg_feats(d["obj_feats"]),
                                  jfeats.calculate_avg_feats(d["obj_feats"]))
    by_obj = {o: tfeats.load_obj_feats(p) for o, p in zip(OBJS, paths)}
    for name, fn in (("calculate_feats2", lambda m: m.calculate_feats2(test_poses, by_obj)),
                     ("calculate_avg_feats_inference", lambda m: m.calculate_avg_feats_inference(paths)),
                     ("calculate_feats2_inference", lambda m: m.calculate_feats2_inference(test_poses, paths))):
        got, want = fn(tfeats), fn(jfeats)
        assert sorted(got) == sorted(want) == list(OBJS), name
        for o in OBJS:  # the same numpy code on both sides
            np.testing.assert_array_equal(got[o], want[o], err_msg=name)


@pytest.mark.parametrize("mode", ["avg", "pose"])
def test_composition_feats_match_jax(tmp_path, mode):
    rng = np.random.default_rng(4)
    paths = _sidecars(str(tmp_path), rng)
    poses = rng.normal(size=(5, 4, 4)).astype(np.float32) if mode == "pose" else None
    objs = ["a", "missing", "b"]  # an object without a sidecar composes with zeros
    want = np.asarray(jcombined.composition_feats(objs, paths, 144, feats_mode=mode, test_poses=poses))
    got = tcombined.composition_feats(objs, paths, 144, feats_mode=mode, test_poses=poses)
    assert got.dtype == torch.float32 and got.shape == ((3, 144) if mode == "avg" else (5, 3, 144))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[..., 1, :].any() and got[..., 0, :].abs().sum() > 0


def _images(seed=0, size=64):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(size=(size, size, 3)).astype(np.float32)
    gt = 0.5 * gt + 0.5 * np.cumsum(gt, 1) / np.arange(1, size + 1)[None, :, None]  # some structure
    pred = np.clip(gt + rng.normal(scale=0.05, size=gt.shape), 0, 1).astype(np.float32)
    return pred, gt


def test_ms_ssim_and_lpips_substitute_match_jax():
    """64x64 images: ms_ssim (3 scales there) and the LPIPS meter's weight-free
    substitute against JAX's; numpy and torch inputs give the same value."""
    pred, gt = _images()
    # fp32 banded-matrix filters summed in another order
    want = float(jmeters.ms_ssim(jnp.asarray(pred), jnp.asarray(gt)))
    got = float(tmeters.ms_ssim(torch.from_numpy(pred), torch.from_numpy(gt)))
    assert 0.5 < want < 0.99
    assert abs(got - want) <= 1e-5
    assert float(tmeters.ms_ssim(pred, gt)) == got
    jm, tm = jmeters.LPIPSMeter(), tmeters.LPIPSMeter()
    assert tm.name == jm.name == "LPIPS* (ms-ssim-dist)" and not tm.available
    for s in (0, 1):
        p, g = _images(s)
        jm.update(p, g)
        tm.update(torch.from_numpy(p), g)
    assert abs(tm.measure() - jm.measure()) <= 1e-5
    assert tm.report().startswith("LPIPS* (ms-ssim-dist) = ")
    rgba_p = np.concatenate([pred, pred[..., :1]], -1)
    rgba_g = np.concatenate([gt, gt[..., :1]], -1)
    assert abs(tmeters.rgba_ssim(rgba_p, rgba_g) - jmeters.rgba_ssim(rgba_p, rgba_g)) <= 1e-5
    assert abs(float(tmeters.psnr(pred, gt)) - float(jmeters.psnr(jnp.asarray(pred), jnp.asarray(gt)))) <= 1e-4


def test_lpips_meter_refuses_weights_it_cannot_read(tmp_path, monkeypatch):
    """A weights file the npz LPIPS cannot read (keys missing) is passed
    over, as JAX's meter passes it over: the meter measures with what comes
    next (the lpips package, else the labelled substitute), never with a
    half-read network."""
    weights = tmp_path / "lpips_alex.npz"
    np.savez(weights, conv0_w=np.zeros((64, 3, 11, 11), np.float32))
    monkeypatch.setenv("FOCNERF_LPIPS_NPZ", str(weights))
    meter = tmeters.LPIPSMeter()
    assert meter.name == jmeters.LPIPSMeter().name
    assert meter.name in ("LPIPS* (ms-ssim-dist)", "LPIPS (alex)")


def _object_workspaces(root, seeds=(1, 2), radii=(0.7, 0.45)):
    """JAX object workspaces ``<root>/ws_<obj>`` as main_nerf -O training
    leaves them (EMA params distinct from params, an occupancy grid), and
    their feature sidecars under ``<root>/obj_feats``, where the composition
    CLIs read them."""
    from focnerf_tpu.ops.occupancy import OccupancyState
    from focnerf_tpu.train.state import create_train_state, make_optimizer

    jcfg = jparse(["scene"] + MODEL).nerf_config()
    ckpts = []
    for obj, seed, radius in zip(OBJS, seeds, radii):
        ema = jax.tree.map(jnp.asarray, visible_params(jcfg, seed=seed))
        raw = jax.tree.map(jnp.asarray, visible_params(jcfg, seed=seed + 10))
        state = create_train_state(jax.random.key(0), jcfg, make_optimizer(), params=raw)
        state = state._replace(ema_params=ema, step=jnp.asarray(5, jnp.int32))
        grid = sphere_density_grid(jcfg.bound, radius=radius)
        occ = OccupancyState(jnp.asarray(grid), jnp.asarray(grid.mean()), jnp.asarray(2, jnp.int32))
        ckpt = os.path.join(root, f"ws_{obj}", "checkpoints")
        mgr = jckpt.CheckpointManager(ckpt)
        mgr.save(state, occ)
        mgr.close()
        jckpt.save_model_config(ckpt, jcfg)
        ckpts.append(ckpt)
    _sidecars(root, np.random.default_rng(8))
    return ckpts


@pytest.fixture(scope="module")
def composition(tmp_path_factory):
    """(scene, JAX root, the port's root): the same two objects."""
    from jax_ckpt_to_torch import convert

    base = tmp_path_factory.mktemp("composition")
    scene = make_synthetic_scene(str(base / "scene"), n_train=3, n_val=2)
    rootj, roott = str(base / "rootj"), str(base / "roott")
    for ckpt in _object_workspaces(rootj):
        rel = os.path.relpath(ckpt, rootj)
        assert convert(ckpt, os.path.join(roott, rel)) == 5
    shutil.copytree(os.path.join(rootj, "obj_feats"), os.path.join(roott, "obj_feats"))
    return scene, rootj, roott


def test_object_loading_matches_jax(composition):
    """load_object_params returns the EMA params (not the raw ones), equal to
    JAX's, with the saved config; the occupancy grid and the discovery
    helpers agree too."""
    _, rootj, roott = composition
    for obj in OBJS:
        jdir, tdir = (os.path.join(r, f"ws_{obj}", "checkpoints") for r in (rootj, roott))
        jparams, jcfg = jckpt.load_object_params(jdir)
        tparams, tcfg = tckpt.load_object_params(tdir, device="cpu")
        assert tcfg.compute_dtype == torch.bfloat16 and tcfg.stochastic_corners == jcfg.stochastic_corners == 1
        assert tcfg.num_levels == jcfg.num_levels == 4 and tcfg.bound == jcfg.bound == 1.0
        np.testing.assert_array_equal(tparams["grid"].numpy(), np.asarray(jparams["grid"]))
        for name in ("sigma_net", "color_net", "yolo_net"):
            for tw, jw in zip(tparams[name], jparams[name]):
                np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        raw, _ = tckpt.load_object_params(tdir, use_ema=False, device="cpu")
        assert not torch.equal(raw["grid"], tparams["grid"])
        jocc = jckpt.load_object_occupancy(jdir, jcfg)
        tocc = tckpt.load_object_occupancy(tdir, tcfg, device="cpu")
        np.testing.assert_array_equal(tocc.density_grid.numpy(), np.asarray(jocc.density_grid))
    assert [os.path.relpath(p, roott) for p in tckpt.gather_checkpoints(roott)] == \
        [os.path.relpath(p, rootj) for p in jckpt.gather_checkpoints(rootj)] == \
        [os.path.join(f"ws_{o}", "checkpoints") for o in OBJS]
    assert [os.path.basename(p) for p in tckpt.gather_obj_feats(roott)] == ["a.npz", "b.npz"]
    for argv in ([], ["--objects_of_interest", "b"]):
        args = ["scene", "--ckpt_dir", roott] + argv
        assert tcombined.discover_objects(tparse(args)) == jcombined.discover_objects(jparse(args))
    assert tcombined._ws_prefix(tparse(["scene", "--ckpt_dir", roott])) == "ws"
    with pytest.raises(FileNotFoundError):
        tckpt.load_object_params(os.path.join(roott, "nowhere"), tcfg, device="cpu")


def _psnrs(log_path):
    with open(log_path) as f:
        return [tuple(float(part.split()[1]) for part in line.split("|")[1:3])
                for line in f if line.startswith("view ")]


@pytest.mark.parametrize("cli,edit", [
    ("combined", []),
    ("editable", ["--edit_object", "b", "--offset_x", "0.3"]),
    # a rotation takes the uniform path
    ("editable", ["--edit_object", "b", "--rotate_z", "90", "--num_steps", "48"]),
])
def test_cli_matches_jax(composition, tmp_path, cli, edit):
    scene, rootj, roott = composition
    outj, outt = str(tmp_path / "outj"), str(tmp_path / "outt")
    jmod, tmod = (jcombined, tcombined) if cli == "combined" else (jeditable, teditable)
    composite_rays_fused.launches = 0
    tmod.main([scene, "--ckpt_dir", roott, "--workspace", outt] + MODEL + edit, device="cpu")
    assert composite_rays_fused.launches == 0  # CPU run: the plain compositor only
    jmod.main([scene, "--ckpt_dir", rootj, "--workspace", outj] + MODEL + edit)

    for sub in ("rgbs_w", "rgbs_b", "depth_w"):
        for v in range(2):
            got = read_image(os.path.join(outt, sub, f"{v:04d}.png")).astype(int)
            want = read_image(os.path.join(outj, sub, f"{v:04d}.png")).astype(int)
            assert got.shape == want.shape and got.shape[:2] == (32, 32), (sub, got.shape)
            # bf16 (-O) on both sides: the same bf16-rounded operands with fp32
            # sums; PNGs truncate to 1/255, so a value at a level's edge may
            # land one level apart
            assert np.abs(got - want).max() <= 1, (sub, v, np.abs(got - want).max())
    img = read_image(os.path.join(outt, "rgbs_w", "0000.png"))
    # the objects cover part of the view (the uniform path has no grid to
    # empty the space around these random fields)
    assert 0.05 < (img < 250).mean() <= (1.0 if "--rotate_z" in edit else 0.95)
    for (tw, tb), (jw, jb) in zip(_psnrs(os.path.join(outt, "log.txt")), _psnrs(os.path.join(outj, "log.txt"))):
        assert abs(tw - jw) <= 0.05 and abs(tb - jb) <= 0.05
    with open(os.path.join(outt, "log.txt")) as f:
        log = f.read()
    assert "==== composition summary ====\nobjects: ['a', 'b']\nbg=w: PSNR = " in log
    assert "| SSIM = " in log and "| LPIPS* (ms-ssim-dist) = " in log
    for sub in ("ground_truth_w", "ground_truth_b", "depth_b"):
        assert os.path.exists(os.path.join(outt, sub, "0001.png"))
    if cli == "editable":
        assert os.path.exists(os.path.join(outt, "composite.mp4")) or \
            os.path.exists(os.path.join(outt, "composite_0001.png"))


def test_edit_moves_the_object(composition, tmp_path):
    """The translated edit renders differently from the plain composition."""
    scene, _, roott = composition
    frames = [teditable.main([scene, "--ckpt_dir", roott, "--workspace", str(tmp_path / name)] + MODEL + edit,
                             device="cpu")
              for name, edit in (("plain", []), ("moved", ["--edit_object", "b", "--offset_x", "0.3"]))]
    assert len(frames[0]) == 2 and np.abs(frames[0][0].astype(int) - frames[1][0].astype(int)).max() > 20


def test_refusals_and_device(composition, tmp_path):
    scene, _, roott = composition
    argv = [scene, "--ckpt_dir", roott, "--workspace", str(tmp_path / "out")] + MODEL
    with pytest.raises(ValueError, match="not a multiple of the block"):  # --baked is ported
        tcombined.main(argv + ["--baked", "--bake_res", "40", "--no-bake_gate"], device="cpu")
    with pytest.raises(SystemExit, match="not among composed objects"):
        teditable.main(argv + ["--edit_object", "nothing"], device="cpu")
    # a voxel-trained object workspace: JAX's message without --baked
    vox_root = str(tmp_path / "vox")
    shutil.copytree(roott, vox_root, symlinks=True)
    os.makedirs(os.path.join(vox_root, "ws_vox"))
    open(os.path.join(vox_root, "ws_vox", "baked_256_sh0.npz"), "wb").close()
    vox_argv = [scene, "--ckpt_dir", vox_root, "--workspace", str(tmp_path / "out2")] + MODEL
    with pytest.raises(SystemExit, match=r"voxel-trained objects \['vox'\] have no network"):
        tcombined.main(vox_argv, device="cpu")
    # with --baked the volume must match the composition's resolution and degree
    jb.save_volume(os.path.join(vox_root, "ws_vox", "baked_16_sh0.npz"),
                   jb.BakedVolume(rgba=jnp.zeros((32, 32, 32, 4)), bound=1.0))
    with pytest.raises(SystemExit, match=r"is 32\^3/sh0 but the composition is 16\^3/sh0"):
        tcombined.main(vox_argv + BAKED + ["--no-bake_gate"], device="cpu")
    if not torch.cuda.is_available():
        for mod in (tcombined, teditable):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                mod.main(argv)


BAKED = ["--baked", "--bake_res", "16"]


def _compare_outputs(outt, outj, n_views=2, levels=1):
    for sub in ("rgbs_w", "rgbs_b", "depth_w"):
        for v in range(n_views):
            got = read_image(os.path.join(outt, sub, f"{v:04d}.png")).astype(int)
            want = read_image(os.path.join(outj, sub, f"{v:04d}.png")).astype(int)
            assert got.shape == want.shape and got.shape[:2] == (32, 32), (sub, got.shape)
            assert np.abs(got - want).max() <= levels, (sub, v, np.abs(got - want).max())
    for (tw, tb_), (jw, jb_) in zip(_psnrs(os.path.join(outt, "log.txt")), _psnrs(os.path.join(outj, "log.txt"))):
        assert abs(tw - jw) <= 0.05 and abs(tb_ - jb_) <= 0.05


@pytest.mark.parametrize("cli,edit", [
    ("combined", []),
    ("combined", ["--bake_quantize", "--bake_sh", "2"]),
    ("editable", ["--edit_object", "b", "--rotate_z", "90", "--offset_x", "0.3"]),
])
def test_baked_cli_matches_jax(composition, tmp_path, cli, edit):
    """``--baked``: each object baked at 16^3 with its gate report, moved by
    its edit, merged (quantized, resident, with --bake_quantize) and every
    view rendered by shear-warp, as the JAX CLI does."""
    scene, rootj, roott = composition
    outj, outt = str(tmp_path / "outj"), str(tmp_path / "outt")
    jmod, tmod = (jcombined, tcombined) if cli == "combined" else (jeditable, teditable)
    composite_rays_fused.launches = 0
    tmod.main([scene, "--ckpt_dir", roott, "--workspace", outt] + MODEL + BAKED + edit, device="cpu")
    assert composite_rays_fused.launches == 0  # CPU run: the plain compositor only
    gates = {o: json.load(open(os.path.join(roott, f"ws_{o}", "bake_quality.json"))) for o in OBJS}
    jmod.main([scene, "--ckpt_dir", rootj, "--workspace", outj] + MODEL + BAKED + edit)
    # bf16 (-O) fields on both sides: a hidden unit may round to the
    # neighbouring bf16 value, which moves a baked voxel by ~1e-3
    _compare_outputs(outt, outj, levels=2)
    for o in OBJS:
        want = json.load(open(os.path.join(rootj, f"ws_{o}", "bake_quality.json")))
        got = gates[o]
        assert got["views"] == want["views"] == 2 and got["bake_resolution"] == 16
        assert got["sh_deg"] == want["sh_deg"] == (2 if "--bake_sh" in edit else 0)
        assert abs(got["psnr_baked_vs_exact_mean"] - want["psnr_baked_vs_exact_mean"]) <= 0.1
    with open(os.path.join(outt, "log.txt")) as f:
        log = f.read()
    assert "[baked] a: baked in " in log and "[baked] 2 objects baked+merged at 16^3" in log
    assert ("quantization" in log) == ("--bake_quantize" in edit)
    img = read_image(os.path.join(outt, "rgbs_w", "0000.png"))
    assert 0.05 < (img < 250).mean() <= 0.95


def test_baked_edit_moves_the_object(composition, tmp_path):
    scene, _, roott = composition
    common = [scene, "--ckpt_dir", roott] + MODEL + BAKED + ["--no-bake_gate"]
    frames = [teditable.main(common + ["--workspace", str(tmp_path / name)] + edit, device="cpu")
              for name, edit in (("plain", []), ("moved", ["--edit_object", "b", "--offset_x", "0.8"]),
                                 ("turned", ["--edit_object", "b", "--offset_x", "0.8", "--rotate_z", "90"]))]
    # b (radius 0.45) sits inside a (0.7) until it is moved out
    diff = lambda x, y: np.abs(x[0].astype(int) - y[0].astype(int)).max()  # noqa: E731
    assert diff(frames[0], frames[1]) > 20 and diff(frames[0], frames[2]) > 20
    assert diff(frames[1], frames[2]) > 0  # the rotation turned it


def test_voxel_workspace_composes_beside_a_checkpoint(composition, tmp_path):
    """A workspace holding only a JAX-saved ``baked_16_sh0.npz`` (as
    main_voxel writes it) composes with --baked beside checkpointed objects,
    as in the JAX CLI; its density is divided by the model's density_scale."""
    scene, rootj, roott = composition
    roots = {}
    for name, src in (("j", rootj), ("t", roott)):
        root = str(tmp_path / f"root{name}")
        shutil.copytree(src, root, symlinks=True)
        shutil.rmtree(os.path.join(root, "ws_b"))
        os.makedirs(os.path.join(root, "ws_vox"))
        vol = jb.BakedVolume(rgba=jnp.asarray(np.load(VOXEL_NPZ)["rgba"]), bound=1.0)
        jb.save_volume(os.path.join(root, "ws_vox", "baked_16_sh0.npz"), vol)
        roots[name] = root
    outj, outt = str(tmp_path / "outj"), str(tmp_path / "outt")
    argv = MODEL + BAKED + ["--no-bake_gate"]
    frames = tcombined.main([scene, "--ckpt_dir", roots["t"], "--workspace", outt] + argv, device="cpu")
    jcombined.main([scene, "--ckpt_dir", roots["j"], "--workspace", outj] + argv)
    _compare_outputs(outt, outj, levels=2)
    with open(os.path.join(outt, "log.txt")) as f:
        log = f.read()
    assert "[baked] vox: loaded" in log and "objects: ['a', 'vox']" in log
    # the voxel object is in the frame: the composition differs from a alone
    alone = tcombined.main([scene, "--ckpt_dir", roots["t"], "--workspace", str(tmp_path / "alone"),
                            "--objects_of_interest", "a"] + argv, device="cpu")
    assert np.abs(frames[0].astype(int) - alone[0].astype(int)).max() > 20


@pytest.fixture(scope="module", autouse=True)
def _voxel_npz(tmp_path_factory):
    global VOXEL_NPZ
    from test_torch_baked import blob_volume

    VOXEL_NPZ = str(tmp_path_factory.mktemp("vox") / "vol.npz")
    rgba = blob_volume(R=16, seed=31)
    rgba[..., -1] *= 0.5
    np.savez(VOXEL_NPZ, rgba=rgba)
