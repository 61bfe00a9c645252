"""``main_voxel`` (apps/main_voxel.py) end to end on the CPU, each family on
a tiny scene (bake_res 16, 24x24 views, a few steps): the artifacts, the
log lines that tools/parity.py's regexes read, the JAX loaders reading
what the port wrote, the refused multi-device options, and
``--steps_per_dispatch 4`` (the fused dispatch) giving the parameters of 1."""

import os
import re

import numpy as np
import pytest
import torch

from focnerf_tpu.render import baked as jb
from focnerf_tpu.train import voxel_dynamic as jdyn
from focnerf_tpu.train import voxel_kplanes as jkp
from focnerf_tpu.train import voxel_vm as jvm
from focnerf_tpu_torch.apps import main_voxel
from focnerf_tpu_torch.data import procedural


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("voxel_scenes")
    static = procedural.make_hard_scene(str(root / "static"), n_train=6, n_val=2, n_test=1, H=24, W=24,
                                        gt_res=32, device="cpu")
    dynamic = procedural.make_hard_dynamic_scene(str(root / "dynamic"), n_times=3, views_per_time=2,
                                                 n_val_times=2, H=24, W=24, gt_res=32, device="cpu")
    return static, dynamic


def run(scene, ws, *extra, iters=4):
    argv = [scene, "--workspace", ws, "--iters", str(iters), "--bake_res", "16", "--scale", "1.0",
            "--bound", "1.0", *extra]
    return main_voxel.main(argv, device="cpu")


def parity_numbers(out: str):
    """What tools/parity.py's run_voxel reads from the output."""
    val = re.findall(r"val PSNR: ([0-9.]+) dB", out)
    train = re.findall(r"train PSNR ([0-9.]+) dB", out)
    assert val and train, out
    return float(val[-1]), float(train[-1])


def test_dense_writes_what_jax_reads(scenes, tmp_path, capsys):
    ws = str(tmp_path / "dense")
    vol, info = run(scenes[0], ws)
    out = capsys.readouterr().out
    val, train = parity_numbers(out)
    assert np.isfinite(val) and abs(val - info["val_psnr"]) < 0.01 and info["step_mse"].shape == (4,)
    assert re.search(r"\[voxel\] 4 iters in [0-9.]+s — train PSNR [0-9.]+ dB, [0-9]+ rays/s", out)
    jvol = jb.load_volume(os.path.join(ws, "baked_16_sh0.npz"))
    np.testing.assert_allclose(np.asarray(jvol.rgba), vol.rgba.numpy(), rtol=1e-3, atol=1e-3)  # fp16 file
    assert os.path.exists(os.path.join(ws, "mesh.obj")) and "[mesh] marching tetrahedra" in out
    with open(os.path.join(ws, "log.txt")) as f:
        assert re.fullmatch(r"voxel res=16 sh=0 iters=4 val_psnr=[0-9.]+\n", f.read())


def test_dense_quantized_screen_and_sh(scenes, tmp_path, capsys):
    ws = str(tmp_path / "q")
    run(scenes[0], ws, "--bake_quantize", "--voxel_supervise", "screen", "--bake_sh", "2", iters=2)
    out = capsys.readouterr().out
    assert "(uint8)" in out and "[bake-gate] quantized-vs-float" in out
    assert os.path.exists(os.path.join(ws, "bake_quality.json"))
    jvol = jb.load_volume(os.path.join(ws, "baked_16_sh2.npz"))
    assert jvol.sh_deg == 2 and jvol.rgba.shape == (16, 16, 16, 13)


def test_vm_writes_what_jax_reads_and_warm_starts(scenes, tmp_path, capsys):
    ws = str(tmp_path / "vm")
    vol, info = run(scenes[0], ws, "--voxel_vm", "4")
    field, bound, sh = jvm.load_vm_field(os.path.join(ws, "vmfield_16_r4.npz"))
    assert (bound, sh) == (1.0, 0) and field.planes.shape == (3, 16, 16, 4, 4)
    np.testing.assert_allclose(np.asarray(jvm.collapse_vm(field)),
                               np.asarray(jvm.collapse_vm(jvm.VMField(*(t.numpy() for t in info["field"])))),
                               atol=5e-3)  # fp16 factors
    assert jb.load_volume(os.path.join(ws, "baked_16_sh0.npz")).rgba.shape == (16, 16, 16, 4)
    parity_numbers(capsys.readouterr().out)
    run(scenes[0], ws, "--voxel_vm", "4", iters=1)
    assert "[vmvoxel] resuming factors from" in capsys.readouterr().out


@pytest.mark.parametrize("family", ["dynvoxel", "kplanes"])
def test_dynamic_families_write_what_jax_reads(scenes, tmp_path, capsys, family):
    ws = str(tmp_path / family)
    flags = ["--voxel_dynamic", "--voxel_rank", "2"] if family == "dynvoxel" else ["--voxel_kplanes", "2"]
    field, info = run(scenes[1], ws, *flags, "--voxel_time_slots", "4")
    out = capsys.readouterr().out
    val, _ = parity_numbers(out)
    assert np.isfinite(val)
    path = os.path.join(ws, f"{family}_16_sh0.npz")
    if family == "dynvoxel":
        jf, bound, sh = jdyn.load_dyn_field(path)
        want = jdyn.collapse_field(jf, 0.5)
        from focnerf_tpu_torch.train.voxel_dynamic import collapse_field as collapse
    else:
        jf, bound, sh = jkp.load_kplanes_field(path)
        want = jkp.collapse_kplanes(jf, 0.5)
        from focnerf_tpu_torch.train.voxel_kplanes import collapse_kplanes as collapse
    assert (bound, sh) == (1.0, 0)
    np.testing.assert_allclose(np.asarray(want), collapse(field, 0.5).numpy(), atol=2e-2, rtol=2e-3)  # fp16
    for t in ("0.00", "1.00"):
        assert os.path.exists(os.path.join(ws, f"mesh_t{t}.obj"))
    with open(os.path.join(ws, "log.txt")) as f:
        assert f.read().startswith(f"{family} res=16 rank=2 iters=4 val_psnr=")


# the multi-device flag combinations the port refuses (JAX's guards, and
# --voxel_dp with c2f); --voxel_sp, --voxel_dp and --voxel_sp
# --voxel_kplanes themselves train (tests/test_torch_parallel.py,
# test_torch_voxel_sp.py, test_torch_factor_sp.py)
@pytest.mark.parametrize("flags,name", [(["--voxel_sp", "--voxel_vm", "4"], "--voxel_sp"),
                                        (["--voxel_sp", "--voxel_dp", "2", "--voxel_c2f", "2"], "--voxel_dp"),
                                        (["--voxel_sp", "--voxel_kplanes", "2", "--voxel_dp", "2"], "--voxel_sp")])
def test_multi_device_options_are_refused_by_name(scenes, tmp_path, flags, name):
    with pytest.raises(ValueError, match=name) as e:
        run(scenes[0], str(tmp_path / "sp"), *flags)
    assert flags[-2] in str(e.value)  # the option to drop is named too


def test_steps_per_dispatch_gives_the_parameters_of_one(scenes, tmp_path, monkeypatch):
    """The fused dispatch runs (chunks of 4 and a tail of 1) and trains the
    parameters of the per-step loop, bit for bit on the CPU."""
    from focnerf_tpu_torch.train import voxel

    one, _ = run(scenes[0], str(tmp_path / "k1"), iters=5)
    chunked, real = [], voxel._fused_field_steps
    monkeypatch.setattr(voxel, "_fused_field_steps", lambda *a, **k: (chunked.append(a[2]), real(*a, **k))[1])
    four, _ = run(scenes[0], str(tmp_path / "k4"), "--steps_per_dispatch", "4", iters=5)
    assert chunked == [4]
    assert torch.equal(one.rgba, four.rgba)
