"""Trainer options the port refuses or ignores, the eval meters, and the
profiler's busy time, on the CPU:

  - ``--rand_pose`` without CLIP weights trains on after one warning, as
    JAX's trainer does, and the sampling options reach the dataset;
  - ``evaluate`` reports PSNR, SSIM and LPIPS as JAX's does;
  - ``--grid_int8`` prints why it is ignored (``--no-preload`` is honoured:
    the host pipeline, tests/test_torch_native_loader.py);
  - ``utils/measure.busy_ms`` counts overlapping device events once.
"""

import os
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from helpers import make_synthetic_scene  # noqa: E402
from test_torch_model import SMALL  # noqa: E402

from focnerf_tpu.data.provider import DatasetOptions as JDatasetOptions  # noqa: E402
from focnerf_tpu.data.provider import NeRFDataset as JNeRFDataset  # noqa: E402
from focnerf_tpu.models import nerf as jnerf  # noqa: E402
from focnerf_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from focnerf_tpu_torch import interop  # noqa: E402
from focnerf_tpu_torch.apps import main_nerf  # noqa: E402
from focnerf_tpu_torch.config import parse_options  # noqa: E402
from focnerf_tpu_torch.models import nerf as tnerf  # noqa: E402
from focnerf_tpu_torch.utils import measure  # noqa: E402

TINY = ["--scale", "1.0", "--bound", "1.0", "--grid_levels", "4", "--num_rays", "64", "--iters", "1",
        "--disable_yolo"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_synthetic_scene(str(tmp_path_factory.mktemp("opts") / "scene"), n_train=2, n_val=1)


def test_rand_pose_is_refused(scene, tmp_path, capsys, monkeypatch):
    """No longer refused: with no CLIP model to load (transformers is made
    unimportable here, as on the card's machine) ``--rand_pose 0
    --clip_text`` warns once and trains its ordinary steps."""
    opt = parse_options([scene, "-O", "--error_map", "--patch_size", "4", "--rand_pose", "3", "--radius", "2"])
    ds = opt.dataset_options()
    assert (ds.error_map, ds.patch_size, ds.rand_pose, ds.radius) == (True, 4, 3, 2.0)
    monkeypatch.setitem(sys.modules, "transformers", None)
    (tr,) = main_nerf.main([scene, "-O", "--workspace", str(tmp_path / "ws")] + TINY
                           + ["--rand_pose", "0", "--clip_text", "a sphere", "--mesh_res", "0"], device="cpu")
    assert tr.rand_pose == -1 and tr.clip_steps == [] and tr.global_step == len(tr.step_losses) == 2  # one epoch
    assert capsys.readouterr().out.count("no CLIP loss available") == 1


def test_evaluate_reports_the_jax_metrics(scene, tmp_path):
    """The same params on both sides: the same result keys (PSNR, SSIM and
    the weight-free ``LPIPS*``), values, and metric names in the log line."""
    from focnerf_tpu_torch.data.provider import DatasetOptions, NeRFDataset
    from focnerf_tpu_torch.train.state import TrainState
    from focnerf_tpu_torch.train.trainer import Trainer

    jcfg = jnerf.NeRFConfig(**dict(SMALL, use_objfeat=False), compute_dtype=jax.numpy.float32)
    tcfg = tnerf.NeRFConfig(**dict(SMALL, use_objfeat=False), compute_dtype=torch.float32)
    common = dict(num_steps=16, max_ray_batch=512, use_checkpoint="scratch")
    jtr = JTrainer("ngp", jcfg, workspace=str(tmp_path / "j"), use_tensorboard=False, **common)
    ttr = Trainer("ngp", tcfg, workspace=str(tmp_path / "t"), device="cpu", **common)
    ttr.state = TrainState(interop.params_from_jax(jax.tree.map(np.asarray, jtr.state.params), tcfg, "cpu"),
                           lr=1e-2, iters=1)
    want = jtr.evaluate(JNeRFDataset(JDatasetOptions(path=scene, scale=1.0), split="val"), use_ema=False,
                        save_images=False)
    got = ttr.evaluate(NeRFDataset(DatasetOptions(path=scene, scale=1.0), split="val", device="cpu"),
                       use_ema=False, save_images=False)
    assert list(got) == list(want) == ["PSNR", "SSIM", "LPIPS* (ms-ssim-dist)"]
    for k in want:  # fp32 renders summed in another order
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    logs = []
    for ws in ("j", "t"):
        with open(tmp_path / ws / "log_ngp.txt") as f:
            logs.append([line for line in f if line.startswith("[eval epoch")][-1])
    for line in logs:
        assert "PSNR = " in line and "| SSIM = " in line and "| LPIPS* (ms-ssim-dist) = " in line


@pytest.mark.parametrize("flags,said", [
    (["--grid_int8"], ["--grid_int8 is ignored"]),
    (["--no-preload"], []),  # the host pipeline: honoured, nothing to say
    (["--grid_int8", "--no-preload"], ["--grid_int8 is ignored"]),
    (["-O", "--no-preload"], []),  # -O preloads
    ([], []),
])
def test_ignored_options_are_announced(capsys, flags, said):
    main_nerf.warn_ignored(parse_options(["scene"] + flags))
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(said)
    for line, what in zip(lines, said):
        assert line.startswith(f"[main_nerf] {what}: ") and len(line) > 60


def test_main_nerf_announces_ignored_options(scene, tmp_path, capsys):
    main_nerf.main([scene, "--workspace", str(tmp_path / "ws"), "--cuda_ray", "--fp16", "--grid_int8"]
                   + TINY + ["--mesh_res", "0", "--no-eval_save_images"], device="cpu")
    assert "[main_nerf] --grid_int8 is ignored" in capsys.readouterr().out


def _event(start, end, name="k", cuda=True, annotation=False):
    return SimpleNamespace(
        name=name, device_type="DeviceType.CUDA" if cuda else "DeviceType.CPU", is_user_annotation=annotation,
        time_range=SimpleNamespace(start=start, end=end, elapsed_us=lambda: end - start),
    )


def test_busy_ms_is_the_union_of_device_intervals():
    events = [
        _event(0, 100, "a"), _event(50, 150, "b"), _event(60, 70, "c"),  # overlap: busy 0-150
        _event(200, 300, "a"), _event(300, 320, "b"),  # touching: 200-320
        _event(400, 1000, cuda=False),  # host op: not device time
        _event(500, 900, annotation=True),  # an annotation's device span covers kernels
    ]
    prof = SimpleNamespace(events=lambda: events)
    assert measure.busy_ms(prof) == pytest.approx(0.27)
    assert measure.union_ms([]) == 0.0
    by_name = {}
    for name, ms in measure.device_events(prof):
        by_name[name] = by_name.get(name, 0.0) + ms
    # per-name sums keep each event's own time: 0.1 + 0.1 + 0.12 + 0.01 > 0.27
    assert by_name == pytest.approx({"a": 0.2, "b": 0.12, "c": 0.01})
    assert sum(by_name.values()) > measure.busy_ms(prof)
