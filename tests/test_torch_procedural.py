"""The procedural hard scene (data/procedural.py) on the CPU: the volume
and a small scene held against the JAX package's."""

import json
import os

import numpy as np

from focnerf_tpu.data import procedural as jproc
from focnerf_tpu_torch.data import procedural as tproc
from focnerf_tpu_torch.data.png import read_image


def test_hard_volume_equals_jax():
    for R, bound in ((16, 1.0), (24, 1.5)):
        got, want = tproc.hard_volume(R, bound), jproc.hard_volume(R, bound)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert (tproc.hard_volume(32)[..., -1] > 0).mean() > 0.01


def test_make_hard_scene_matches_jax(tmp_path):
    """32x32 views rendered from a 32^3 volume: the same cameras, and PNGs
    within one level (1/255) of JAX's."""
    kw = dict(n_train=2, n_val=1, n_test=1, H=32, W=32, gt_res=32, seed=3)
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    jproc.make_hard_scene(jroot, **kw)
    assert tproc.make_hard_scene(troot, device="cpu", **kw) == troot
    stamp = os.path.getmtime(os.path.join(troot, "train", "r_0.png"))
    tproc.make_hard_scene(troot, device="cpu", **kw)  # the same parameters: kept
    assert os.path.getmtime(os.path.join(troot, "train", "r_0.png")) == stamp
    for split, n in (("train", 2), ("val", 1), ("test", 1)):
        with open(os.path.join(jroot, f"transforms_{split}.json")) as f:
            jmeta = json.load(f)
        with open(os.path.join(troot, f"transforms_{split}.json")) as f:
            tmeta = json.load(f)
        assert tmeta["camera_angle_x"] == jmeta["camera_angle_x"] and len(tmeta["frames"]) == n
        for tf, jf in zip(tmeta["frames"], jmeta["frames"]):
            assert tf["file_path"] == jf["file_path"]
            np.testing.assert_allclose(tf["transform_matrix"], jf["transform_matrix"], atol=1e-6)
            got = read_image(os.path.join(troot, tf["file_path"] + ".png")).astype(int)
            want = read_image(os.path.join(jroot, jf["file_path"] + ".png")).astype(int)
            assert got.shape == want.shape == (32, 32, 4)
            # fp32 renders ~1e-5 apart; truncation to 1/255 may land one level apart
            assert np.abs(got - want).max() <= 1
            assert 0.02 < (got[..., 3] > 0).mean() < 0.98


def test_hard_dynamic_volume_equals_jax():
    for t in (0.0, 0.5, 1.0):
        got, want = tproc.hard_dynamic_volume(32, t), jproc.hard_dynamic_volume(32, t)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    # the sphere moves: the volumes at t = 0 and 0.5 differ
    assert (tproc.hard_dynamic_volume(32, 0.0) != tproc.hard_dynamic_volume(32, 0.5)).any()


def test_make_hard_dynamic_scene_matches_jax(tmp_path):
    """2 timestamps x 2 views of 24x24 from a 32^3 volume: the same cameras
    and times, and PNGs within one level of JAX's."""
    kw = dict(n_times=2, views_per_time=2, n_val_times=2, H=24, W=24, gt_res=32, seed=1)
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    jproc.make_hard_dynamic_scene(jroot, **kw)
    assert tproc.make_hard_dynamic_scene(troot, device="cpu", **kw) == troot
    for split, n in (("train", 4), ("val", 2), ("test", 2)):
        with open(os.path.join(jroot, f"transforms_{split}.json")) as f:
            jmeta = json.load(f)
        with open(os.path.join(troot, f"transforms_{split}.json")) as f:
            tmeta = json.load(f)
        assert len(tmeta["frames"]) == n and tmeta["camera_angle_x"] == jmeta["camera_angle_x"]
        for tf, jf in zip(tmeta["frames"], jmeta["frames"]):
            assert (tf["file_path"], tf["time"]) == (jf["file_path"], jf["time"])
            np.testing.assert_allclose(tf["transform_matrix"], jf["transform_matrix"], atol=1e-6)
            got = read_image(os.path.join(troot, tf["file_path"] + ".png")).astype(int)
            want = read_image(os.path.join(jroot, jf["file_path"] + ".png")).astype(int)
            assert got.shape == want.shape == (24, 24, 4)
            assert np.abs(got - want).max() <= 1
