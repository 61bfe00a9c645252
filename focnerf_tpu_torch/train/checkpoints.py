"""Checkpoint save/load with ``torch.save``.

Twin of focnerf_tpu/train/checkpoints.py. A checkpoint directory
(``workspace_<obj>/checkpoints``, the reference's per-object convention)
holds ``model_config.json`` in the JAX package's format and rolling
``ckpt_<step>.pt`` files, each a dict of ``step``, ``params``,
``ema_params`` and, from training, ``ema_count`` and ``optimizer`` (the
Adam state dict), plus, when the model trained with the occupancy grid,
``occupancy`` (density_grid, mean_density, iter_density). ``BestCheckpoint``
keeps the train state of the best eval PSNR in ``<workspace>/best``, without
the grid (nerf/utils.py:1434-1493).
"""

from __future__ import annotations

import json
import os
import re
from typing import List, Optional

import torch

from focnerf_tpu_torch.interop import config_from_dict, config_to_dict
from focnerf_tpu_torch.ops.occupancy import OccupancyState

_CKPT_RE = re.compile(r"^ckpt_(\d+)\.pt$")


def save_model_config(directory: str, cfg) -> None:
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "model_config.json"), "w") as f:
        json.dump(config_to_dict(cfg), f, indent=2)


def load_model_config(directory: str):
    """The saved NeRFConfig, or None when the directory has none."""
    path = os.path.join(directory, "model_config.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return config_from_dict(json.load(f))


def _atomic_save(payload: dict, path: str):
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _to_cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_cpu(v) for v in tree]
    return tree


class CheckpointManager:
    def __init__(self, directory: str, max_keep: int = 2):
        self.directory = os.path.abspath(directory)
        self.max_keep = max_keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> List[int]:
        found = (_CKPT_RE.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.pt")

    def save(self, state: dict, occupancy: Optional[OccupancyState] = None):
        """``state``: ``TrainState.state_dict()``, or for serving at least
        ``step``, ``params`` and ``ema_params``."""
        payload = _to_cpu(dict(state))
        if occupancy is not None:
            payload["occupancy"] = _to_cpu(occupancy._asdict())
        step = int(payload["step"])
        _atomic_save(payload, self._path(step))
        for old in self.steps()[: -self.max_keep] if self.max_keep > 0 else []:
            os.remove(self._path(old))

    def restore(self, device, step: Optional[int] = None) -> Optional[dict]:
        """{"step", "params", "ema_params", "occupancy" (OccupancyState or None)}
        of ``step`` (default: the latest) on ``device``; None if there is none."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        payload = torch.load(self._path(step), map_location=device, weights_only=True)
        occ = payload.get("occupancy")
        payload["occupancy"] = OccupancyState(**occ) if occ is not None else None
        return payload


class BestCheckpoint:
    """The eval-PSNR-driven best train state: ``best.pt`` and the PSNR it was
    saved at in ``best_metric.json`` (no occupancy grid)."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)

    def metric(self) -> Optional[float]:
        path = os.path.join(self.directory, "best_metric.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return float(json.load(f)["psnr"])

    def save(self, state: dict, psnr: float):
        os.makedirs(self.directory, exist_ok=True)
        _atomic_save(_to_cpu(dict(state)), os.path.join(self.directory, "best.pt"))
        with open(os.path.join(self.directory, "best_metric.json"), "w") as f:
            json.dump({"psnr": float(psnr), "step": int(state["step"])}, f)

    def restore(self, device) -> Optional[dict]:
        path = os.path.join(self.directory, "best.pt")
        if not os.path.exists(path):
            return None
        return torch.load(path, map_location=device, weights_only=True)
