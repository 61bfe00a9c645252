"""The port's small modules against their JAX twins on the CPU: Morton codes
(core/geometry.py), mask dilation, the scripts (sorted transforms, a frame
folder to video), the numerical-health guards (utils/debug.py) and the
stage timer and trace (utils/profiling.py)."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focnerf_tpu.core.geometry import morton3d as jmorton, morton3d_invert as jinvert
from focnerf_tpu_torch.core.geometry import morton3d, morton3d_invert


# ------------------------------------------------------------------ Morton
def test_morton_codes_match_jax():
    c = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 1], [3, 0, 0], [127, 127, 127], [1023, 1023, 1023]])
    rng = np.random.default_rng(4)
    c = np.concatenate([c, rng.integers(0, 1024, size=(4096, 3))])
    want = np.asarray(jmorton(jnp.asarray(c)))
    got = morton3d(torch.from_numpy(c))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[:6].numpy(), [1, 2, 4, 7, 0b1001, 128**3 - 1])
    back = morton3d_invert(got)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jinvert(jnp.asarray(want))))
    np.testing.assert_array_equal(back.numpy(), c)  # the round trip, the top bits set included


# ---------------------------------------------------------------- dilation
@pytest.mark.parametrize("target", [0.0, 50.0, 300.0, 1e6])
def test_dilation_matches_jax(target):
    from focnerf_tpu.utils.dilation import increase_dilation_percentage as jdilate
    from focnerf_tpu_torch.utils.dilation import increase_dilation_percentage

    rng = np.random.default_rng(int(target) % 7)
    for mask in (rng.random((32, 40)) > 0.97, np.zeros((8, 8), bool)):
        got = increase_dilation_percentage(mask, target, max_iters=20)
        np.testing.assert_array_equal(got, jdilate(mask, target, max_iters=20))
        assert (got | mask).sum() == got.sum()  # the original region kept


# ------------------------------------------------------------------ scripts
def test_sort_transforms_matches_jax(tmp_path):
    from focnerf_tpu.utils.scripts import sort_transforms as jsort
    from focnerf_tpu_torch.utils.scripts import sort_transforms

    data = {"camera_angle_x": 0.7, "frames": [{"file_path": p} for p in ("r_10", "r_2", "img", "r_1", "a/r_100")]}
    for name in ("j.json", "t.json"):
        with open(tmp_path / name, "w") as f:
            json.dump(data, f)
    jsort(str(tmp_path / "j.json"))
    out = sort_transforms(str(tmp_path / "t.json"), str(tmp_path / "t_sorted.json"))
    with open(tmp_path / "j.json") as a, open(out) as b:
        assert a.read() == b.read()
    with open(out) as f:
        assert [fr["file_path"] for fr in json.load(f)["frames"]] == ["img", "r_1", "r_2", "r_10", "a/r_100"]


def test_folder_to_video_without_image_libraries(tmp_path, monkeypatch):
    """imageio, PIL and cv2 unimportable (the card's machine): the frames,
    read in numeric order, come out as write_video's numbered PNGs."""
    from focnerf_tpu_torch.data.png import read_png, write_png
    from focnerf_tpu_torch.utils.scripts import folder_to_video

    for i in (10, 2, 1):
        write_png(str(tmp_path / f"f_{i}.png"), np.full((8, 8, 4), i * 20, np.uint8))
    for name in ("cv2", "PIL", "imageio", "imageio.v2"):
        monkeypatch.setitem(sys.modules, name, None)
    out = folder_to_video(str(tmp_path), fps=2)
    assert out == str(tmp_path / "video.mp4")
    frames = [read_png(str(tmp_path / f"video_{k:04d}.png")) for k in range(3)]
    assert [int(f[0, 0, 0]) for f in frames] == [20, 40, 200] and frames[0].shape == (8, 8, 3)


# -------------------------------------------------------------------- debug
def _params():
    rng = np.random.default_rng(0)
    return {"grid": rng.normal(size=(16, 2)).astype(np.float32),
            "sigma_net": [rng.normal(size=(4, 8)).astype(np.float32), rng.normal(size=(8, 1)).astype(np.float32)],
            "steps": np.arange(3)}


def test_tree_health_matches_jax():
    from focnerf_tpu.utils.debug import tree_health as jhealth
    from focnerf_tpu_torch.utils.debug import assert_finite, tree_health

    params = _params()
    params["grid"][3, 1] = np.nan
    params["sigma_net"][1][2, 0] = -np.inf
    tparams = {"grid": torch.from_numpy(params["grid"]), "sigma_net": [torch.from_numpy(a) for a in params["sigma_net"]],
               "steps": torch.arange(3)}
    want = jhealth(jax.tree.map(jnp.asarray, params))
    np.testing.assert_equal(tree_health(tparams), want)  # NaN absmax equal to NaN
    np.testing.assert_equal(tree_health(params), want)
    assert want["['grid']"]["nan"] == 1 and want["['sigma_net'][1]"]["inf"] == 1
    with pytest.raises(FloatingPointError, match=r"\['grid'\]"):
        assert_finite(tparams, "after the step")
    assert_finite({"ok": torch.ones(3, dtype=torch.bfloat16)})


def test_checkify_step_raises_on_the_first_non_finite_value():
    from focnerf_tpu_torch.train.state import TrainState
    from focnerf_tpu_torch.utils.debug import checkify_step

    params = {"grid": torch.from_numpy(_params()["grid"])}

    def step(state, scale):
        loss = (state.params["grid"] * scale).sum()
        loss.backward()
        state.apply_gradients()
        return {"loss": loss.detach()}

    state = TrainState(params, lr=1e-2, iters=10)
    checked = checkify_step(step)
    assert torch.isfinite(checked(state, 1.0)["loss"]) and state.step == 1
    before = state.params["grid"].detach().clone()
    with pytest.raises(FloatingPointError, match="gradients"):
        checked(state, float("inf"))  # inf * finite table: a non-finite gradient
    assert state.step == 1 and torch.equal(state.params["grid"], before)  # Adam never applied it
    assert "apply_gradients" not in vars(state)  # the guard is gone again
    state.params["grid"].grad = None
    with torch.no_grad():
        state.params["grid"][0, 0] = float("nan")
    with pytest.raises(FloatingPointError):
        checked(state, 0.0)


# ---------------------------------------------------------------- profiling
def test_stage_timer_and_trace(tmp_path):
    from focnerf_tpu.utils.profiling import StageTimer as JTimer
    from focnerf_tpu_torch.utils.profiling import StageTimer, trace

    timers = (JTimer(), StageTimer())
    for t in timers:
        for _ in range(2):
            with t.stage("encode", sync=None):
                pass
        with t.stage("march", sync=torch.ones(2) if isinstance(t, StageTimer) else jnp.ones(2)):
            pass
    lines = [t.summary().splitlines() for t in timers]
    assert [line.split(":")[0] for line in lines[1]] == [line.split(":")[0] for line in lines[0]] == ["encode", "march"]
    assert lines[1][0].startswith("encode: n=2 total=") and lines[1][0].endswith("ms")
    timers[1].write(str(tmp_path / "logs" / "times.txt"))
    timers[1].write(str(tmp_path / "logs" / "times.txt"))
    with open(tmp_path / "logs" / "times.txt") as f:
        assert f.read().count("march: n=1") == 2
    with trace(None) as prof:
        assert prof is None
    with trace(str(tmp_path / "trace")) as prof:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "aten::mm" in f.read()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
