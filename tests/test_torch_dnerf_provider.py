"""The D-NeRF provider (data/dnerf_provider.py) on the CPU against the JAX
package's: per-frame times from a ``time`` key, index-derived without one,
and normalized when they exceed 1; and, where JAX reads the times in JSON
order, the port's times following the sorted (kept) frames."""

import json
import os

import numpy as np
import pytest

from focnerf_tpu.data.dnerf_provider import DNeRFDataset as JaxDNeRF
from focnerf_tpu.data.provider import DatasetOptions as JaxOptions
from focnerf_tpu_torch.data.dnerf_provider import DNeRFDataset
from focnerf_tpu_torch.data.png import write_image
from focnerf_tpu_torch.data.provider import DatasetOptions


def write_scene(root, times, split="train", order=None, names=None):
    """A blender split of 4x4 RGBA frames ``names`` (default r_<i>) listed
    in ``order`` in the JSON, with the given ``time`` per frame (None: no
    key)."""
    n = len(times)
    names = names or [f"r_{i}" for i in range(n)]
    os.makedirs(os.path.join(root, split), exist_ok=True)
    frames = []
    for i in order if order is not None else range(n):
        pose = np.eye(4)
        pose[:3, 3] = (0.0, 0.0, 3.0 + i)
        write_image(os.path.join(root, split, names[i] + ".png"), np.full((4, 4, 4), 10 * i, np.uint8))
        fr = {"file_path": f"{split}/{names[i]}", "transform_matrix": pose.tolist()}
        if times[i] is not None:
            fr["time"] = times[i]
        frames.append(fr)
    with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
        json.dump({"camera_angle_x": 0.8, "frames": frames}, f)
    return root


def both(root, split="train"):
    port = DNeRFDataset(DatasetOptions(path=root, scale=1.0), split=split, device="cpu")
    jax_ds = JaxDNeRF(JaxOptions(path=root, scale=1.0), split=split)
    return port, jax_ds


@pytest.mark.parametrize("times", [
    [0.0, 0.25, 0.5, 0.75, 1.0],  # a time key
    [None] * 6,  # index-derived
    [0.0, 3.0, 6.0, 12.0],  # over 1: divided by the maximum
    [0.5, 0.5, 0.5],
])
def test_times_match_jax(tmp_path, times):
    port, jax_ds = both(write_scene(str(tmp_path), times))
    assert port.times.dtype == np.float32
    np.testing.assert_array_equal(port.times, np.asarray(jax_ds.times))
    np.testing.assert_array_equal(port.times_dev.numpy(), port.times)
    np.testing.assert_allclose(port.poses, np.asarray(jax_ds.poses), atol=1e-6)
    assert port.times.max() <= 1.0
    if times[0] is None:
        np.testing.assert_allclose(port.times, np.arange(6) / 5.0, rtol=1e-6)


def test_times_follow_the_kept_frames_and_batches_carry_them(tmp_path):
    """12 frames listed r_0 ... r_11 in the JSON: the provider sorts them
    (r_10 before r_2), and each frame keeps its own time. JAX reads the
    times in JSON order for a blender split, so from r_10 on its times sit
    on other frames."""
    import torch

    times = [i / 11 for i in range(12)]
    port, jax_ds = both(write_scene(str(tmp_path), times))
    kept = [os.path.basename(p)[:-4] for p in port.paths]
    assert kept[:4] == ["r_0", "r_1", "r_10", "r_11"]
    want = np.array([times[int(k[2:])] for k in kept], np.float32)
    np.testing.assert_array_equal(port.times, want)
    assert not np.array_equal(np.asarray(jax_ds.times), want)  # JAX: JSON order
    np.testing.assert_array_equal(np.sort(np.asarray(jax_ds.times)), np.sort(want))

    batch = port.train_batch(torch.Generator().manual_seed(0))
    assert float(batch["time"]) == port.times[int(batch["view"])]
    assert float(port.eval_view(2)["time"]) == port.times[2]
