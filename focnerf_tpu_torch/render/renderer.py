"""Volume rendering paths.

Twin of focnerf_tpu/render/renderer.py:
  - ``render_rays``: uniform ``num_steps`` samples in [near, far]
    (nerf/renderer.py:126-238), with ``perturb`` jittered by the draws
    ``z_noise`` [N, num_steps]; with ``upsample_steps`` a coarse density
    pass without gradients, whose weights ``sample_pdf`` turns into that
    many importance samples (the draws ``pdf_u``, or midpoint quantiles
    without ``perturb``), merged and sorted; composited through the fused
    kernel with no early exit;
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

import numpy as np
import torch

from focnerf_tpu_torch.core.geometry import near_far_from_aabb, sph_from_ray
from focnerf_tpu_torch.models.nerf import (
    NeRFConfig,
    background_fn,
    color_fn,
    density_fn,
    encode_objfeat,
)
from focnerf_tpu_torch.ops.composite import composite_rays_fused, composite_weights
from focnerf_tpu_torch.ops.hashgrid import _device_tuple
from focnerf_tpu_torch.ops.marching import march_rays, march_rays_skip


def default_aabb(cfg: NeRFConfig, device) -> torch.Tensor:
    """The bound box [6] on ``device``, copied there once per (bound,
    device): a copy inside a CUDA graph capture would sync. Read-only."""
    b = float(cfg.bound)
    return _device_tuple((-b, -b, -b, b, b, b), torch.float32, torch.device(device))


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


def _unit_linspace(n: int, device) -> torch.Tensor:
    """linspace(0, 1, n) in fp32 as jnp.linspace computes it: i times the
    fp32 reciprocal of n - 1, then exactly 1 (torch.linspace rounds some
    entries the other way, and a field's steep fine levels amplify that)."""
    if n == 1:
        return torch.zeros(1, device=device)
    step = torch.arange(n - 1, dtype=torch.float32, device=device) * float(np.float32(1.0 / (n - 1)))
    return torch.cat([step, torch.ones(1, device=device)])


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int, u: Optional[torch.Tensor] = None):
    """Inverse-CDF importance sampling (nerf/renderer.py:13-44): bin edges
    bins [..., T + 1] and weights [..., T] -> samples [..., n_samples] at the
    quantiles ``u`` [..., n_samples] (None: the midpoints
    (k + 0.5) / n_samples, as ``det``)."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)  # [..., T + 1]
    if u is None:
        u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples, device=cdf.device)
        u = u.expand(*cdf.shape[:-1], n_samples)
    u = u.contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)  # #{i : cdf_i <= u}
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    bins_b = torch.gather(bins, -1, torch.clamp(below, max=bins.shape[-1] - 1))
    bins_a = torch.gather(bins, -1, torch.clamp(above, max=bins.shape[-1] - 1))
    denom = torch.where(cdf_a - cdf_b < 1e-5, torch.ones_like(cdf_a), cdf_a - cdf_b)
    t = (u - cdf_b) / denom
    return bins_b + t * (bins_a - bins_b)


def render_rays(
    params,
    cfg: NeRFConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    *,
    num_steps: int = 512,
    upsample_steps: int = 0,
    bg_color=None,
    aabb: Optional[torch.Tensor] = None,
    min_near: float = 0.2,
    obj_feat=None,
    perturb: bool = False,
    z_noise: Optional[torch.Tensor] = None,
    pdf_u: Optional[torch.Tensor] = None,
    u: Optional[torch.Tensor] = None,
) -> Dict[str, Any]:
    """Uniform-sampling render of rays [N, 3] -> dict(image, depth, weights_sum, sigmas).

    ``perturb`` (training) takes its draws as tensors: ``z_noise`` [N,
    num_steps] jitters each sample by (z_noise - 0.5) of a step, ``pdf_u``
    [N, upsample_steps] are the importance samples' quantiles, and ``u``
    [N * (num_steps + upsample_steps), n_stoch, K, 3] the stochastic-corner
    draws of the encode when the config trains with them. Without
    ``perturb`` the importance samples sit at the midpoint quantiles.
    """
    if perturb and (z_noise is None or (upsample_steps > 0 and pdf_u is None)):
        raise ValueError("perturb=True needs the jitter draws z_noise (and pdf_u with upsample_steps)")
    aabb = _aabb(cfg, aabb, rays_o.device)
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, min_near)
    nears = nears[:, None]
    fars = fars[:, None]
    z = _unit_linspace(num_steps, rays_o.device)[None, :]
    z_vals = nears + (fars - nears) * z
    sample_dist = (fars - nears) / num_steps
    if perturb:
        z_vals = z_vals + (z_noise - 0.5) * sample_dist

    if upsample_steps > 0:
        # the coarse pass only places the new samples (JAX stops their
        # gradient), so it runs without autograd
        with torch.no_grad():
            xyz_c = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
            xyz_c = torch.maximum(torch.minimum(xyz_c, aabb[3:]), aabb[:3])
            sig_c, _ = density_fn(params, cfg, xyz_c)
            deltas_c = torch.cat([z_vals[..., 1:] - z_vals[..., :-1], sample_dist], dim=-1)
            w_c = composite_weights(sig_c, deltas_c, cfg.density_scale)
            # a + (b - a) / 2, not (a + b) / 2: rays that miss the box carry
            # the 3e38 near/far sentinel, and a + b overflows to inf there
            mids = z_vals[..., :-1] + 0.5 * (z_vals[..., 1:] - z_vals[..., :-1])
            new_z = sample_pdf(mids, w_c[..., 1:-1], upsample_steps, pdf_u if perturb else None)
            z_vals = torch.sort(torch.cat([z_vals, new_z], -1), -1).values

    xyzs = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    xyzs = torch.maximum(torch.minimum(xyzs, aabb[3:]), aabb[:3])
    sigmas, geo_feat = density_fn(params, cfg, xyzs, u if perturb else None)
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
    samples and ``upsample_steps`` importance samples at the midpoint
    quantiles. The last chunk is padded with rays (o=0, d=+z). Returns
    (image [H, W, 3], depth [H, W]) on the params' device.
    """
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
                params, cfg, o, d, num_steps=num_steps, upsample_steps=upsample_steps,
                bg_color=bg_color, aabb=aabb, min_near=min_near, obj_feat=obj_feat,
            )
        images.append(res["image"])
        depths.append(res["depth"])
    image = torch.cat(images)[:n].reshape(H, W, 3)
    depth = torch.cat(depths)[:n].reshape(H, W)
    return image, depth
