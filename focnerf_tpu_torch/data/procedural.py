"""Hard procedural scene: thin structures + high-frequency texture.

Twin of focnerf_tpu/data/procedural.py. The static scene: a Lego-like
object (a wireframe cube of ~2-voxel struts, a 3x3 pillar grid on a thin
floor plate, a centre sphere with a 3-D checker/stripe texture) voxelized by
``hard_volume`` and rendered by the shear-warp renderer to a blender-layout
dataset (``transforms_{split}.json`` + RGBA PNGs) that the CLIs read as they
read a real capture. The renders are the ground truth. The dynamic scene
(``hard_dynamic_volume``, ``make_hard_dynamic_scene``): the sphere orbits
and a picket of pillars swings with t inside the static wireframe, with
several views per timestamp and a ``time`` per frame for the D-NeRF
provider. PNGs go through ``data/png.py``, so no imaging package is needed.
"""

from __future__ import annotations

import json
import os

import numpy as np


def _frame_and_plate(X, Y, Z, e: float, w: float):
    """The wireframe cube of half-extent ``e`` (at least two coordinates
    pinned to a face, the third inside) and the floor plate, struts of
    half-width ``w``: two boolean grids."""
    near_e = lambda A: np.abs(np.abs(A) - e) < w  # noqa: E731
    inside = lambda A: np.abs(A) < e + w  # noqa: E731
    frame = (
        (near_e(X) & near_e(Y) & inside(Z))
        | (near_e(X) & near_e(Z) & inside(Y))
        | (near_e(Y) & near_e(Z) & inside(X))
    )
    plate = (np.abs(Z + e) < w) & (np.abs(X) < e + w) & (np.abs(Y) < e + w)
    return frame, plate


def _textured(X, Y, Z, bound: float, stripe_phase, frame, plate, pillars, sphere):
    """rgb + sigma [R, R, R, 4]: sigma 60 on the geometry; a high-frequency
    checker x stripes texture (~12 cycles across the object), the stripes
    along ``stripe_phase``."""
    sigma = np.where(frame | pillars | plate | sphere, 60.0, 0.0).astype(np.float32)
    f = 12.0 * np.pi / bound
    checker = 0.5 + 0.5 * np.sign(np.sin(f * X) * np.sin(f * Y) * np.sin(f * Z))
    stripes = 0.5 + 0.5 * np.sin(2.5 * f * stripe_phase / 3.0)
    r = np.where(sphere, stripes, checker)
    g = np.where(frame | plate, 0.85, 0.25 + 0.5 * stripes)
    b = np.where(pillars, 0.9, 1.0 - checker)
    rgb = np.stack([r, g, b], -1).astype(np.float32)
    return np.concatenate([rgb, sigma[..., None]], -1)


def hard_volume(R: int = 256, bound: float = 1.0):
    """Procedural GT volume [R, R, R, 4] (rgb + sigma), numpy."""
    c = (np.arange(R, dtype=np.float32) + 0.5) / R * 2 * bound - bound
    X, Y, Z = np.meshgrid(c, c, c, indexing="ij")

    e = 0.6  # cube half-extent
    w = 1.6 * (2 * bound / R)  # strut half-width ~1.6 voxels: thin
    frame, plate = _frame_and_plate(X, Y, Z, e, w)

    # 3x3 pillar grid (radius ~1.6 voxels) standing on the floor plate
    pillars = np.zeros_like(frame)
    for px in (-0.3, 0.0, 0.3):
        for py in (-0.3, 0.0, 0.3):
            pillars |= ((X - px) ** 2 + (Y - py) ** 2 < w**2 * 4) & (np.abs(Z) < e)

    sphere = X**2 + Y**2 + Z**2 < 0.25**2
    return _textured(X, Y, Z, bound, X + Y + Z, frame, plate, pillars, sphere)


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


def hard_dynamic_volume(R: int, t: float, bound: float = 1.0):
    """Time-conditioned hard volume [R, R, R, 4] (numpy): the textured
    centre sphere orbits and a picket of thin pillars swings with t, inside
    the static wireframe and on the floor plate."""
    c = (np.arange(R, dtype=np.float32) + 0.5) / R * 2 * bound - bound
    X, Y, Z = np.meshgrid(c, c, c, indexing="ij")
    e = 0.6
    w = 1.6 * (2 * bound / R)
    frame, plate = _frame_and_plate(X, Y, Z, e, w)

    ang = 2.0 * np.pi * t
    cx, cy = 0.3 * np.cos(ang), 0.3 * np.sin(ang)  # orbiting sphere
    sphere = (X - cx) ** 2 + (Y - cy) ** 2 + Z**2 < 0.2**2

    lean = 0.35 * np.sin(ang)  # pillars swing in x with height
    pillars = np.zeros_like(frame)
    for py in (-0.3, 0.0, 0.3):
        px = lean * (Z + e) / (2 * e)
        pillars |= ((X - px) ** 2 + (Y - py) ** 2 < w**2 * 4) & (np.abs(Z) < e)
    return _textured(X, Y, Z, bound, (X - cx) + (Y - cy) + Z, frame, plate, pillars, sphere)


def make_hard_dynamic_scene(
    root: str,
    n_times: int = 8,
    views_per_time: int = 4,
    n_val_times: int = 4,
    H: int = 400,
    W: int = 400,
    gt_res: int = 128,
    radius: float = 2.5,
    bound: float = 1.0,
    seed: int = 0,
    device=None,
) -> str:
    """Write the blender-layout dynamic scene, its GT rendered on ``device``
    (None: ``cuda``): ``views_per_time`` poses per train timestamp, one per
    val and test timestamp, each frame with its ``time``. Returns ``root``;
    a scene already written with the same parameters
    (``hard_dynamic_scene.json``) is kept."""
    import torch

    from focnerf_tpu_torch import resolve_device
    from focnerf_tpu_torch.core.camera import rand_poses
    from focnerf_tpu_torch.data.png import write_image
    from focnerf_tpu_torch.render.baked import BakedVolume, render_baked

    marker = os.path.join(root, "hard_dynamic_scene.json")
    params = dict(
        n_times=n_times, views_per_time=views_per_time, n_val_times=n_val_times, H=H, W=W,
        gt_res=gt_res, radius=radius, bound=bound, seed=seed, version=1,
    )
    if os.path.exists(marker):
        with open(marker) as fh:
            if json.load(fh) == params:
                return root

    device = resolve_device(device)
    os.makedirs(root, exist_ok=True)
    fl = 1.2 * W
    fov_x = 2 * np.arctan(W / (2 * fl))
    rng = np.random.default_rng(seed)
    vols = {}

    def vol_at(t: float):
        if t not in vols:
            rgba = torch.from_numpy(hard_dynamic_volume(gt_res, t, bound)).to(device)
            vols[t] = BakedVolume(rgba=rgba, bound=bound)
        return vols[t]

    for split, times, vpt in (
        ("train", np.linspace(0, 1, n_times), views_per_time),
        ("val", np.linspace(0, 1, n_val_times), 1),
        ("test", np.linspace(0, 1, n_val_times), 1),
    ):
        frames = []
        os.makedirs(os.path.join(root, split), exist_ok=True)
        i = 0
        for t in times:
            for pose in rand_poses(rng, vpt, radius=radius):
                img, _, alpha = render_baked(vol_at(float(t)), pose, (fl, fl, W / 2.0, H / 2.0), H, W,
                                             bg_color=1.0)
                rgba = torch.cat([img, alpha[..., None]], -1).cpu().numpy()
                path = f"{split}/r_{i}"
                write_image(os.path.join(root, path + ".png"), (np.clip(rgba, 0, 1) * 255).astype(np.uint8))
                frames.append({"file_path": path, "time": float(t),
                               "transform_matrix": ngp_to_nerf(pose).tolist()})
                i += 1
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as fh:
            json.dump({"camera_angle_x": float(fov_x), "frames": frames}, fh)
    with open(marker, "w") as fh:
        json.dump(params, fh)
    return root
