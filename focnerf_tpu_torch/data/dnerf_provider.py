"""Dynamic-scene dataset: NeRFDataset plus a normalized time per frame.

Twin of focnerf_tpu/data/dnerf_provider.py (dnerf/provider.py:171-193):
frames carry a ``time`` key in transforms_*.json, or their time is the
frame's index over the frame count; times over 1 are divided by their
maximum. ``times`` (numpy, [V]) follows the kept frames' order, and
``times_dev`` is the same on the dataset's device; ``train_batch`` and
``eval_view`` add the view's ``time``.

The frames are sorted by ``file_path`` before their times are read, in
every layout, as the provider sorts the poses and images (and as the
reference does). JAX sorts them only for colmap: for a blender split whose
file names do not sort in their JSON order (``r_10`` before ``r_2``), its
times are read in JSON order and land on other frames' images. The two
agree wherever the JSON lists its frames in sorted order.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from focnerf_tpu_torch.data.provider import DatasetOptions, NeRFDataset


class DNeRFDataset(NeRFDataset):
    def __init__(self, opt: DatasetOptions, split: str = "train", **kw):
        super().__init__(opt, split=split, **kw)
        # re-read the transforms for the per-frame times, in kept-frame order
        tj = os.path.join(opt.path, f"transforms_{split}.json")
        if not os.path.exists(tj):
            tj = os.path.join(opt.path, "transforms.json")
        with open(tj) as f:
            frames = json.load(f)["frames"]
        frames = sorted(frames, key=lambda d: d["file_path"])

        kept_names = {os.path.basename(p) for p in self.paths}
        times = []
        for i, fr in enumerate(frames):
            name = os.path.basename(fr["file_path"])
            if not os.path.splitext(name)[1]:
                name += ".png"
            if self.paths and name not in kept_names:
                continue
            times.append(float(fr["time"]) if "time" in fr else i / max(len(frames) - 1, 1))
        if not times:
            times = [0.0] * self.n_views
        t = np.asarray(times[: self.n_views], np.float32)
        tmax = t.max() if t.max() > 0 else 1.0
        self.times = t / tmax if tmax > 1.0 else t
        self.times_dev = torch.as_tensor(self.times).to(self.device)

    def train_batch(self, generator: torch.Generator) -> dict:
        batch = super().train_batch(generator)
        batch["time"] = self.times_dev[batch["view"]]
        return batch

    def eval_view(self, view: int) -> dict:
        out = super().eval_view(view)
        out["time"] = self.times_dev[view]
        return out
