"""Ray generation from a camera pose + intrinsics, and training pixel draws.

Twin of focnerf_tpu/core/rays.py: pixel centres at (col + 0.5, row + 0.5),
camera direction ((i - cx)/fx, (j - cy)/fy, 1) normalized and rotated by the
c2w rotation; flat pixel index = row * W + col. ``sample_ray_indices`` has
the JAX twin's three modes (uniform pixels, patches, error-map importance
sampling); its random numbers come from ``index_draws`` or are passed in.
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


ERROR_MAP_RES = 128  # the error map's coarse grid side


def index_draws(generator: torch.Generator, H: int, W: int, n_rays: int, *, error_map: bool = False,
                patch_size: int = 1, device=None) -> dict:
    """The random numbers of one ``sample_ray_indices`` call, from
    ``generator`` (on ``device``): ``inds`` [n] uniform pixels; with
    ``patch_size`` > 1 the patch corners ``ix``, ``iy`` [n // p^2] (uniform in
    [0, H - p) and [0, W - p)); with ``error_map`` the Gumbel uniforms
    ``gumbel_u`` [128 * 128] and the in-cell jitters ``jx``, ``jy`` [n]."""
    n = min(n_rays, H * W)
    kw = dict(generator=generator, device=device)
    if patch_size > 1:
        m = n // (patch_size**2)
        return {"ix": torch.randint(0, H - patch_size, (m,), **kw),
                "iy": torch.randint(0, W - patch_size, (m,), **kw)}
    if error_map:
        return {"gumbel_u": torch.rand((ERROR_MAP_RES**2,), **kw), "jx": torch.rand((n,), **kw),
                "jy": torch.rand((n,), **kw)}
    return {"inds": torch.randint(0, H * W, (n,), **kw)}


def sample_ray_indices(H: int, W: int, n_rays: int, draws: dict, error_map: Optional[torch.Tensor] = None,
                       patch_size: int = 1):
    """Flat pixel indices of a training batch -> (inds [n] int64,
    inds_coarse [n] int64 or None), n = min(n_rays, H * W), from ``draws``
    (``index_draws``'s, made with the same mode):

      - uniform pixels;
      - ``patch_size`` > 1: n // p^2 contiguous p x p patches;
      - ``error_map`` [128 * 128]: importance sampling of the coarse cells
        (Gumbel top-k, which draws without replacement in proportion to the
        map), then a uniform pixel inside each cell; ``inds_coarse`` are
        the cells, for the map's update.
    """
    n = min(n_rays, H * W)
    if patch_size > 1:
        ar = torch.arange(patch_size, device=draws["ix"].device)
        pi, pj = torch.meshgrid(ar, ar, indexing="ij")
        rows = (draws["ix"][:, None] + pi.reshape(-1)[None]).reshape(-1)
        cols = (draws["iy"][:, None] + pj.reshape(-1)[None]).reshape(-1)
        return rows * W + cols, None
    if error_map is None:
        return draws["inds"], None
    logits = torch.log(torch.clamp(error_map.reshape(-1).float(), min=1e-12))
    gumbel = -torch.log(-torch.log(draws["gumbel_u"] + 1e-12) + 1e-12)
    inds_coarse = torch.topk(logits + gumbel, n).indices
    sx, sy = H / float(ERROR_MAP_RES), W / float(ERROR_MAP_RES)
    cx = torch.div(inds_coarse, ERROR_MAP_RES, rounding_mode="floor").float()
    cy = (inds_coarse % ERROR_MAP_RES).float()
    px = torch.clamp((cx * sx + draws["jx"] * sx).to(torch.int64), 0, H - 1)
    py = torch.clamp((cy * sy + draws["jy"] * sy).to(torch.int64), 0, W - 1)
    return px * W + py, inds_coarse
