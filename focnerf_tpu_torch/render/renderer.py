"""Volume rendering paths.

Twin of focnerf_tpu/render/renderer.py:
  - ``render_rays``: uniform ``num_steps`` samples in [near, far]
    (nerf/renderer.py:126-238), composited through the fused kernel with
    no early exit; importance upsampling comes later;
  - ``render_rays_occupancy``: occupancy-bitfield marching (the ladder, or
    with ``occ_skip`` the sphere-trace skip walk) into a fixed [N, slab]
    slab, one batched field evaluation, early-terminated compositing through
    the fused kernel (nerf/renderer.py:243-354). With ``perturb`` (training)
    it takes its draws as tensors: the march start jitter ``noise`` [N] and
    the stochastic-corner uniforms ``u`` [N * slab, n_stoch, K, 3], and it
    is differentiable in the params;
  - ``render_image``: a Python loop over fixed-size ray chunks, without
    gradients.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from focnerf_tpu_torch.core.geometry import near_far_from_aabb, sph_from_ray
from focnerf_tpu_torch.models.nerf import (
    NeRFConfig,
    background_fn,
    color_fn,
    density_fn,
    encode_objfeat,
)
from focnerf_tpu_torch.ops.composite import composite_rays_fused
from focnerf_tpu_torch.ops.marching import march_rays, march_rays_skip


def default_aabb(cfg: NeRFConfig, device) -> torch.Tensor:
    b = cfg.bound
    return torch.tensor([-b, -b, -b, b, b, b], dtype=torch.float32, device=device)


def _aabb(cfg: NeRFConfig, aabb, device) -> torch.Tensor:
    if aabb is None:
        return default_aabb(cfg, device)
    return torch.as_tensor(aabb, dtype=torch.float32, device=device)


def _objfeat_enc(params, cfg: NeRFConfig, obj_feat):
    if not cfg.use_objfeat:
        return None
    if obj_feat is None:
        raise ValueError("cfg.use_objfeat=True requires obj_feat")
    obj_feat = torch.as_tensor(obj_feat, dtype=torch.float32, device=params["grid"].device)
    return encode_objfeat(params, cfg, obj_feat)


def _background(params, cfg: NeRFConfig, rays_o, rays_d, bg_color):
    if cfg.bg_radius > 0:
        return background_fn(params, cfg, sph_from_ray(rays_o, rays_d, cfg.bg_radius), rays_d)
    return 1.0 if bg_color is None else bg_color


def render_rays(
    params,
    cfg: NeRFConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    *,
    num_steps: int = 512,
    bg_color=None,
    aabb: Optional[torch.Tensor] = None,
    min_near: float = 0.2,
    obj_feat=None,
) -> Dict[str, Any]:
    """Uniform-sampling render of rays [N, 3] -> dict(image, depth, weights_sum, sigmas)."""
    aabb = _aabb(cfg, aabb, rays_o.device)
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, min_near)
    nears = nears[:, None]
    fars = fars[:, None]
    z = torch.linspace(0.0, 1.0, num_steps, dtype=torch.float32, device=rays_o.device)[None, :]
    z_vals = nears + (fars - nears) * z
    sample_dist = (fars - nears) / num_steps

    xyzs = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    xyzs = torch.maximum(torch.minimum(xyzs, aabb[3:]), aabb[:3])
    sigmas, geo_feat = density_fn(params, cfg, xyzs)
    deltas = torch.cat([z_vals[..., 1:] - z_vals[..., :-1], sample_dist], dim=-1)
    dirs = rays_d[:, None, :].expand(xyzs.shape)
    rgbs = color_fn(params, cfg, dirs, geo_feat, _objfeat_enc(params, cfg, obj_feat))
    bg = _background(params, cfg, rays_o, rays_d, bg_color)
    ori_z = torch.clamp((z_vals - nears) / torch.clamp(fars - nears, min=1e-10), 0.0, 1.0)
    image, weights_sum, depth = composite_rays_fused(
        sigmas.contiguous(), rgbs.contiguous(), deltas.contiguous(), ori_z.contiguous(),
        bg_color=bg, density_scale=cfg.density_scale, T_thresh=0.0,
    )
    return {
        "image": image,
        "depth": depth,
        "weights_sum": weights_sum,
        "sigmas": sigmas,
    }


def render_rays_occupancy(
    params,
    cfg: NeRFConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    occ_bits: torch.Tensor,
    *,
    dt_gamma: float = 0.0,
    max_steps: int = 1024,
    slab: int = 128,
    bg_color=None,
    aabb: Optional[torch.Tensor] = None,
    min_near: float = 0.2,
    T_thresh: float = 1e-4,
    obj_feat=None,
    grid_size: int = 128,
    occ_skip: Optional[torch.Tensor] = None,
    perturb: bool = False,
    noise: Optional[torch.Tensor] = None,
    u: Optional[torch.Tensor] = None,
) -> Dict[str, Any]:
    """Occupancy-accelerated render of rays [N, 3] (run_cuda's path).

    ``occ_skip`` (the skip field of ``occ_bits``) selects the skip walk.
    ``perturb`` jitters the march start by ``noise`` and, when the config
    trains with stochastic corners, encodes with the draws ``u``. Depth is
    normalized to [0, 1] as clamp(depth - near) / (far - near).
    """
    aabb = _aabb(cfg, aabb, rays_o.device)
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, min_near)
    if perturb and noise is None:
        raise ValueError("perturb=True needs the march jitter draws (noise)")
    common = dict(
        bound=cfg.bound, dt_gamma=dt_gamma, max_steps=max_steps, slab=slab,
        grid_size=grid_size, noise=noise if perturb else None,
    )
    if occ_skip is not None:
        m = march_rays_skip(rays_o, rays_d, nears, fars, occ_skip, **common)
    else:
        m = march_rays(rays_o, rays_d, nears, fars, occ_bits, **common)
    xyzs = rays_o[:, None, :] + rays_d[:, None, :] * m.ts[..., None]
    xyzs = torch.maximum(torch.minimum(xyzs, aabb[3:]), aabb[:3])
    sigmas, geo_feat = density_fn(params, cfg, xyzs, u if perturb else None)
    sigmas = torch.where(m.valid, sigmas, torch.zeros_like(sigmas))
    dirs = rays_d[:, None, :].expand(xyzs.shape)
    rgbs = color_fn(params, cfg, dirs, geo_feat, _objfeat_enc(params, cfg, obj_feat))
    bg = _background(params, cfg, rays_o, rays_d, bg_color)
    image, weights_sum, depth = composite_rays_fused(
        sigmas.contiguous(), rgbs.contiguous(), m.dts.contiguous(), m.ts.contiguous(),
        bg_color=bg, density_scale=cfg.density_scale, T_thresh=T_thresh,
    )
    depth = torch.clamp(depth - nears, min=0.0) / torch.clamp(fars - nears, min=1e-10)
    return {
        "image": image,
        "depth": depth,
        "weights_sum": weights_sum,
        "sigmas": sigmas,
        "n_samples": m.count,
        "march_iters": m.iters,
    }


def padded_rays(pose, intrinsics, H: int, W: int, max_ray_batch: int, device):
    """A view's rays (rays_o, rays_d) [H * W + pad, 3], padded to whole
    chunks of ``max_ray_batch`` with rays o = 0, d = +z."""
    from focnerf_tpu_torch.core.rays import get_rays

    rays = get_rays(pose, intrinsics, H, W, device=device)
    pad = (-H * W) % max_ray_batch
    rd_pad = rays["rays_d"].new_zeros((pad, 3))
    rd_pad[:, 2] = 1.0
    return (torch.cat([rays["rays_o"], rays["rays_o"].new_zeros((pad, 3))]),
            torch.cat([rays["rays_d"], rd_pad]))


@torch.no_grad()
def render_image(
    params,
    cfg: NeRFConfig,
    pose,
    intrinsics,
    H: int,
    W: int,
    *,
    num_steps: int = 512,
    upsample_steps: int = 0,
    max_ray_batch: int = 4096,
    bg_color=None,
    aabb=None,
    min_near: float = 0.2,
    obj_feat=None,
    occ_bits: Optional[torch.Tensor] = None,
    dt_gamma: float = 0.0,
    max_steps: int = 1024,
    slab: int = 64,
    occ_skip: Optional[torch.Tensor] = None,
):
    """Full-image render in chunks of ``max_ray_batch`` rays.

    With ``occ_bits`` the rays go through ``render_rays_occupancy`` (with
    ``occ_skip`` through its skip walk), else through ``num_steps`` uniform
    samples. The last chunk is padded with
    rays (o=0, d=+z). Returns (image [H, W, 3], depth [H, W]) on the params'
    device.
    """
    if upsample_steps > 0:
        raise NotImplementedError("upsample_steps > 0 (sample_pdf) is not ported yet")
    device = params["grid"].device
    aabb = _aabb(cfg, aabb, device)  # once: a per-chunk host copy would sync
    ro, rd = padded_rays(pose, intrinsics, H, W, max_ray_batch, device)
    n = H * W
    images, depths = [], []
    for i in range(0, ro.shape[0], max_ray_batch):
        o, d = ro[i : i + max_ray_batch], rd[i : i + max_ray_batch]
        if occ_bits is not None:
            res = render_rays_occupancy(
                params, cfg, o, d, occ_bits, dt_gamma=dt_gamma, max_steps=max_steps,
                slab=slab, bg_color=bg_color, aabb=aabb, min_near=min_near,
                obj_feat=obj_feat, occ_skip=occ_skip,
            )
        else:
            res = render_rays(
                params, cfg, o, d, num_steps=num_steps, bg_color=bg_color, aabb=aabb,
                min_near=min_near, obj_feat=obj_feat,
            )
        images.append(res["image"])
        depths.append(res["depth"])
    image = torch.cat(images)[:n].reshape(H, W, 3)
    depth = torch.cat(depths)[:n].reshape(H, W)
    return image, depth
