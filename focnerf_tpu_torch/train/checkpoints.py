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

Composition and editing load each object once at startup:
``load_object_params`` (EMA params by default; the saved config wins),
``load_object_occupancy``, and ``gather_checkpoints``/``gather_obj_feats``,
which find the object checkpoints and feature sidecars under a root.
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


def _to(tree, device):
    """``tree``'s tensors, detached, on ``device``; other leaves as they are."""
    if torch.is_tensor(tree):
        return tree.detach().to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to(v, device) for v in tree]
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
        payload = _to(dict(state), "cpu")
        if occupancy is not None:
            payload["occupancy"] = _to(occupancy._asdict(), "cpu")
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
        _atomic_save(_to(dict(state), "cpu"), os.path.join(self.directory, "best.pt"))
        with open(os.path.join(self.directory, "best_metric.json"), "w") as f:
            json.dump({"psnr": float(psnr), "step": int(state["step"])}, f)

    def restore(self, device) -> Optional[dict]:
        path = os.path.join(self.directory, "best.pt")
        if not os.path.exists(path):
            return None
        return torch.load(path, map_location=device, weights_only=True)


def _restore_latest(ckpt_dir: str) -> dict:
    """The latest checkpoint of ``ckpt_dir``, on the CPU."""
    restored = None
    if os.path.isdir(ckpt_dir):
        restored = CheckpointManager(ckpt_dir).restore("cpu")
    if restored is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    return restored


def load_object_params(ckpt_dir: str, cfg=None, use_ema: bool = True, device=None):
    """(params, cfg) of the latest checkpoint of ``ckpt_dir`` on ``device``
    (None: ``cuda``): the EMA params unless ``use_ema`` is False. The saved
    ``model_config.json`` wins over ``cfg``, so an object restores with the
    architecture it was trained with (COMBINED.py:597, loaded once)."""
    from focnerf_tpu_torch import resolve_device

    device = resolve_device(device)
    cfg = load_model_config(ckpt_dir) or cfg
    if cfg is None:
        raise ValueError(f"no model_config.json under {ckpt_dir} and no cfg given")
    payload = _restore_latest(ckpt_dir)
    return _to(payload["ema_params" if use_ema else "params"], device), cfg


def load_object_occupancy(ckpt_dir: str, cfg=None, device=None) -> Optional[OccupancyState]:
    """The latest checkpoint's occupancy grid on ``device``, or None when it
    trained without one (then composition samples uniformly). ``cfg`` is
    accepted for the JAX signature; the grid's shape is the saved one."""
    from focnerf_tpu_torch import resolve_device

    device = resolve_device(device)
    try:
        occ = _restore_latest(ckpt_dir)["occupancy"]
    except FileNotFoundError:
        return None
    return None if occ is None else OccupancyState(*(_to(t, device) for t in occ))


def gather_checkpoints(ckpt_dir: str) -> list:
    """Per-object checkpoint directories ``<root>/<ws>_<obj>/checkpoints``
    under a composition root (nerf/utils.py:161-175)."""
    out = []
    if not os.path.isdir(ckpt_dir):
        return out
    for name in sorted(os.listdir(ckpt_dir)):
        sub = os.path.join(ckpt_dir, name, "checkpoints")
        if os.path.isdir(sub) and name.rsplit("_", 1)[-1]:
            out.append(sub)
    return out


def gather_obj_feats(ckpt_dir: str) -> list:
    """Per-object feature sidecars ``<root>/obj_feats/<obj>.npz``
    (nerf/utils.py:177-187)."""
    feats_dir = os.path.join(ckpt_dir, "obj_feats")
    if not os.path.isdir(feats_dir):
        return []
    return [os.path.join(feats_dir, f) for f in sorted(os.listdir(feats_dir)) if f.endswith(".npz")]
