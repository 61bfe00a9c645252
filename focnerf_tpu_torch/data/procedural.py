"""Hard procedural scene: thin structures + high-frequency texture.

Twin of focnerf_tpu/data/procedural.py, the static scene: a Lego-like
object (a wireframe cube of ~2-voxel struts, a 3x3 pillar grid on a thin
floor plate, a centre sphere with a 3-D checker/stripe texture) voxelized by
``hard_volume`` and rendered by the shear-warp renderer to a blender-layout
dataset (``transforms_{split}.json`` + RGBA PNGs) that the CLIs read as they
read a real capture. The renders are the ground truth. PNGs go through
``data/png.py``, so no imaging package is needed.
"""

from __future__ import annotations

import json
import os

import numpy as np


def hard_volume(R: int = 256, bound: float = 1.0):
    """Procedural GT volume [R, R, R, 4] (rgb + sigma), numpy."""
    c = (np.arange(R, dtype=np.float32) + 0.5) / R * 2 * bound - bound
    X, Y, Z = np.meshgrid(c, c, c, indexing="ij")

    e = 0.6  # cube half-extent
    w = 1.6 * (2 * bound / R)  # strut half-width ~1.6 voxels: thin

    near_e = lambda A: np.abs(np.abs(A) - e) < w  # noqa: E731
    inside = lambda A: np.abs(A) < e + w  # noqa: E731

    # wireframe cube: at least two coordinates pinned to a face, the third inside
    frame = (
        (near_e(X) & near_e(Y) & inside(Z))
        | (near_e(X) & near_e(Z) & inside(Y))
        | (near_e(Y) & near_e(Z) & inside(X))
    )

    # 3x3 pillar grid (radius ~1.6 voxels) standing on the floor plate
    pillars = np.zeros_like(frame)
    for px in (-0.3, 0.0, 0.3):
        for py in (-0.3, 0.0, 0.3):
            pillars |= ((X - px) ** 2 + (Y - py) ** 2 < w**2 * 4) & (np.abs(Z) < e)

    plate = (np.abs(Z + e) < w) & (np.abs(X) < e + w) & (np.abs(Y) < e + w)
    sphere = X**2 + Y**2 + Z**2 < 0.25**2

    geo = frame | pillars | plate | sphere
    sigma = np.where(geo, 60.0, 0.0).astype(np.float32)

    # high-frequency 3-D texture: checker x stripes, ~12 cycles across the object
    f = 12.0 * np.pi / bound
    checker = 0.5 + 0.5 * np.sign(np.sin(f * X) * np.sin(f * Y) * np.sin(f * Z))
    stripes = 0.5 + 0.5 * np.sin(2.5 * f * (X + Y + Z) / 3.0)
    r = np.where(sphere, stripes, checker)
    g = np.where(frame | plate, 0.85, 0.25 + 0.5 * stripes)
    b = np.where(pillars, 0.9, 1.0 - checker)
    rgb = np.stack([r, g, b], -1).astype(np.float32)
    return np.concatenate([rgb, sigma[..., None]], -1)


def ngp_to_nerf(ngp: np.ndarray) -> np.ndarray:
    """The nerf-convention c2w that the provider's nerf_matrix_to_ngp (scale
    1, offset 0) maps back to the ngp pose ``ngp``."""
    out = np.eye(4, dtype=np.float32)
    out[1, :3] = ngp[0, :3] * np.array([1, -1, -1])
    out[2, :3] = ngp[1, :3] * np.array([1, -1, -1])
    out[0, :3] = ngp[2, :3] * np.array([1, -1, -1])
    out[1, 3] = ngp[0, 3]
    out[2, 3] = ngp[1, 3]
    out[0, 3] = ngp[2, 3]
    return out


def make_hard_scene(
    root: str,
    n_train: int = 50,
    n_val: int = 8,
    n_test: int = 8,
    H: int = 800,
    W: int = 800,
    gt_res: int = 256,
    radius: float = 2.5,
    bound: float = 1.0,
    seed: int = 0,
    device=None,
) -> str:
    """Write the blender-layout hard scene, its GT rendered on ``device``
    (None: ``cuda``); returns ``root``. A scene already written with the same
    parameters (``hard_scene.json``) is kept."""
    import torch

    from focnerf_tpu_torch import resolve_device
    from focnerf_tpu_torch.core.camera import rand_poses
    from focnerf_tpu_torch.data.png import write_image
    from focnerf_tpu_torch.render.baked import BakedVolume, render_baked

    marker = os.path.join(root, "hard_scene.json")
    params = dict(
        n_train=n_train, n_val=n_val, n_test=n_test, H=H, W=W,
        gt_res=gt_res, radius=radius, bound=bound, seed=seed, version=1,
    )
    if os.path.exists(marker):
        with open(marker) as fh:
            if json.load(fh) == params:
                return root

    device = resolve_device(device)
    os.makedirs(root, exist_ok=True)
    vol = BakedVolume(rgba=torch.from_numpy(hard_volume(gt_res, bound)).to(device), bound=bound)
    fl = 1.2 * W
    fov_x = 2 * np.arctan(W / (2 * fl))

    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        frames = []
        poses = rand_poses(rng, n, radius=radius)
        os.makedirs(os.path.join(root, split), exist_ok=True)
        for i, pose in enumerate(poses):
            img, _, alpha = render_baked(vol, pose, (fl, fl, W / 2.0, H / 2.0), H, W, bg_color=1.0)
            rgba = torch.cat([img, alpha[..., None]], -1).cpu().numpy()
            path = f"{split}/r_{i}"
            write_image(os.path.join(root, path + ".png"), (np.clip(rgba, 0, 1) * 255).astype(np.uint8))
            frames.append({"file_path": path, "transform_matrix": ngp_to_nerf(pose).tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as fh:
            json.dump({"camera_angle_x": float(fov_x), "frames": frames}, fh)
    with open(marker, "w") as fh:
        json.dump(params, fh)
    return root
