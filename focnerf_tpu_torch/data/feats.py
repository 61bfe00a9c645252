"""Object-feature synthesis for novel (test) views.

Twin of focnerf_tpu/data/feats.py (the reference's nerf/utils.py helpers):

  - the ``obj_feats/<obj>.npz`` sidecar, {"obj_feats": [V, F], "poses":
    [V, 4, 4]}, that ``main_nerf`` training writes per object;
  - ``calculate_feats`` (:189-219): the inverse camera-centre-distance blend
    of saved per-view features onto each test pose;
  - ``calculate_feats2`` / ``calculate_feats2_inference`` (:224-260,
    320-359): the same per object, from a dict or from sidecar files (the
    editing flow);
  - ``calculate_avg_feats`` / ``calculate_avg_feats_inference`` (:264-317):
    the plain mean over training views (the composition flow).
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np


def save_obj_feats(path: str, obj_feats: np.ndarray, poses: np.ndarray):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, obj_feats=np.asarray(obj_feats), poses=np.asarray(poses))


def load_obj_feats(path: str) -> Dict[str, np.ndarray]:
    data = np.load(path)
    return {"obj_feats": data["obj_feats"], "poses": data["poses"]}


def _pose_distance(test_pose: np.ndarray, train_poses: np.ndarray) -> np.ndarray:
    """Euclidean distance between camera centres (utils.py:196-201)."""
    return np.linalg.norm(train_poses[:, :3, 3] - test_pose[:3, 3], axis=-1)


def calculate_feats(
    test_poses: np.ndarray, train_feats: np.ndarray, train_poses: np.ndarray, eps: float = 1e-8
) -> np.ndarray:
    """Inverse camera-centre-distance weighted feature blend -> [T, F] f32."""
    out = []
    for tp in test_poses:
        w = 1.0 / (_pose_distance(tp, train_poses) + eps)
        w = w / w.sum()
        out.append((w[:, None] * train_feats).sum(0))
    return np.stack(out).astype(np.float32)


def calculate_avg_feats(train_feats: np.ndarray) -> np.ndarray:
    """Plain mean over training views -> [F] f32."""
    return np.asarray(train_feats, np.float32).mean(0)


def calculate_feats2(
    test_poses: np.ndarray, feats_by_object: Dict[str, Dict[str, np.ndarray]]
) -> Dict[str, np.ndarray]:
    """{name: {"obj_feats": [V, F], "poses": [V, 4, 4]}} -> {name: [T, F]}."""
    return {
        name: calculate_feats(test_poses, d["obj_feats"], d["poses"])
        for name, d in feats_by_object.items()
    }


def _name(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def calculate_avg_feats_inference(feat_paths: List[str]) -> Dict[str, np.ndarray]:
    """Mean features per object from saved sidecars -> {name: [F]}."""
    return {_name(p): calculate_avg_feats(load_obj_feats(p)["obj_feats"]) for p in feat_paths}


def calculate_feats2_inference(test_poses: np.ndarray, feat_paths: List[str]) -> Dict[str, np.ndarray]:
    """Pose-weighted features per object from saved sidecars -> {name: [T, F]}."""
    out = {}
    for p in feat_paths:
        d = load_obj_feats(p)
        out[_name(p)] = calculate_feats(test_poses, d["obj_feats"], d["poses"])
    return out
