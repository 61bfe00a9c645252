"""Ray generation from a camera pose + intrinsics, and training pixel draws.

Twin of focnerf_tpu/core/rays.py: pixel centres at (col + 0.5, row + 0.5),
camera direction ((i - cx)/fx, (j - cy)/fy, 1) normalized and rotated by the
c2w rotation; flat pixel index = row * W + col. ``sample_ray_indices`` is the
uniform mode of the JAX twin (the error-map and patch modes are not ported).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def get_rays(pose, intrinsics, H: int, W: int, inds: Optional[torch.Tensor] = None, device=None):
    """World-space rays for one camera -> dict(rays_o [N,3], rays_d [N,3], inds [N]).

    ``pose`` [4, 4] (tensor or array); ``device`` defaults to the pose's. A
    pose tensor already on ``device`` is used there (no host copy).
    """
    if device is None:
        device = pose.device if torch.is_tensor(pose) else torch.device("cpu")
    if torch.is_tensor(pose):
        pose = pose.to(device=device, dtype=torch.float32)
    else:
        pose = torch.as_tensor(np.asarray(pose), dtype=torch.float32).to(device)
    fx, fy, cx, cy = (float(np.float32(v)) for v in np.asarray(intrinsics).reshape(-1))
    if inds is None:
        inds = torch.arange(H * W, dtype=torch.int64, device=device)
    rows = torch.div(inds, W, rounding_mode="floor").float()
    cols = (inds % W).float()
    xs = (cols + 0.5 - cx) / fx
    ys = (rows + 0.5 - cy) / fy
    dirs = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    rays_d = dirs @ pose[:3, :3].T
    rays_o = pose[:3, 3].expand(rays_d.shape)
    return {"rays_o": rays_o, "rays_d": rays_d, "inds": inds}


def sample_ray_indices(generator: torch.Generator, H: int, W: int, n_rays: int, device=None):
    """Uniform flat pixel indices [min(n_rays, H*W)] int64 on ``device``,
    drawn from ``generator`` (which must live on that device)."""
    n = min(n_rays, H * W)
    return torch.randint(0, H * W, (n,), generator=generator, device=device)
