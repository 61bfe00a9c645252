"""Volume rendering of the time-conditioned D-NeRF fields, and the
occupancy grid with a time axis.

Twin of focnerf_tpu/render/dnerf_renderer.py:

  - ``render_rays_dnerf``: ``num_steps`` uniform samples in [near, far] at
    time t; with ``perturb`` (training) jittered by the draws ``z_noise``
    [N, num_steps];
  - ``render_rays_dnerf_occupancy``: the ladder ``march_rays`` through the
    time slot's bitfield, or with ``occ_skip`` the skip walk
    ``march_rays_skip``, into a [N, slab] slab; with ``perturb`` the march
    start jitter ``noise`` [N];
  - ``render_image_dnerf``: a Python loop over ``max_ray_batch`` chunks,
    without gradients;
  - ``TimeOccupancyState`` ([T_slots, CAS, H^3]), ``init_time_occupancy``,
    ``update_time_occupancy`` (one slot per call, a full jittered sweep of
    its cells at the slot's centre time) and ``time_occupancy_bitfield``
    (the slot of t, thresholded at min(mean over all slots, thresh)).

Both renderers composite through ``composite_rays_fused`` (the CUDA kernels
on the card), where JAX calls its plain ``composite_rays``: the same
function. The deformation's mean |dx| over the samples is returned as
``deform_mean`` for the trainer's L1 term.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from focnerf_tpu_torch.core.geometry import near_far_from_aabb
from focnerf_tpu_torch.models.dnerf import DNeRFConfig, dnerf_color, dnerf_density
from focnerf_tpu_torch.ops.composite import composite_rays_fused
from focnerf_tpu_torch.ops.marching import march_rays, march_rays_skip
from focnerf_tpu_torch.ops.occupancy import _cascade_world_coords, _cell_coords01, cascade_count
from focnerf_tpu_torch.render.renderer import _aabb, _unit_linspace, padded_rays


def _shade(params, cfg: DNeRFConfig, rays_d, xyzs, t, sigmas_mask=None):
    """(sigmas [N, T], rgbs [N, T, 3], aux) of the field at the samples."""
    sigmas, geo, aux = dnerf_density(params, cfg, xyzs, t)
    if sigmas_mask is not None:
        sigmas = torch.where(sigmas_mask, sigmas, torch.zeros_like(sigmas))
    dirs = rays_d[:, None, :].expand(xyzs.shape)
    return sigmas, dnerf_color(params, cfg, dirs, geo, aux.get("basis_coeff")), aux


def _result(image, weights_sum, depth, sigmas, aux) -> Dict[str, Any]:
    out = {"image": image, "depth": depth, "weights_sum": weights_sum, "sigmas": sigmas}
    if "deform" in aux:
        # the L1 deformation regularizer (dnerf/utils.py:117-119)
        out["deform_mean"] = aux["deform"].abs().mean()
    return out


def render_rays_dnerf(
    params,
    cfg: DNeRFConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    t,
    *,
    num_steps: int = 512,
    perturb: bool = False,
    z_noise: Optional[torch.Tensor] = None,
    bg_color=None,
    aabb: Optional[torch.Tensor] = None,
    min_near: float = 0.2,
) -> Dict[str, Any]:
    """Uniform-sampling render of rays [N, 3] at time t (a scalar or a 0-d
    tensor) -> dict(image, depth, weights_sum, sigmas[, deform_mean]).
    ``perturb`` jitters each sample by (z_noise - 0.5) of a step."""
    if perturb and z_noise is None:
        raise ValueError("perturb=True needs the jitter draws z_noise")
    aabb = _aabb(cfg, aabb, rays_o.device)
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, min_near)
    nears, fars = nears[:, None], fars[:, None]
    z_vals = nears + (fars - nears) * _unit_linspace(num_steps, rays_o.device)[None, :]
    sample_dist = (fars - nears) / num_steps
    if perturb:
        z_vals = z_vals + (z_noise - 0.5) * sample_dist
    xyzs = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    xyzs = torch.maximum(torch.minimum(xyzs, aabb[3:]), aabb[:3])
    sigmas, rgbs, aux = _shade(params, cfg, rays_d, xyzs, t)
    deltas = torch.cat([z_vals[..., 1:] - z_vals[..., :-1], sample_dist], dim=-1)
    ori_z = torch.clamp((z_vals - nears) / torch.clamp(fars - nears, min=1e-10), 0.0, 1.0)
    image, weights_sum, depth = composite_rays_fused(
        sigmas.contiguous(), rgbs.contiguous(), deltas.contiguous(), ori_z.contiguous(),
        bg_color=1.0 if bg_color is None else bg_color, density_scale=cfg.density_scale, T_thresh=0.0,
    )
    return _result(image, weights_sum, depth, sigmas, aux)


def render_rays_dnerf_occupancy(
    params,
    cfg: DNeRFConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    t,
    occ_bits: Optional[torch.Tensor],
    *,
    dt_gamma: float = 0.0,
    max_steps: int = 1024,
    slab: int = 64,
    perturb: bool = False,
    noise: Optional[torch.Tensor] = None,
    bg_color=None,
    aabb: Optional[torch.Tensor] = None,
    min_near: float = 0.2,
    T_thresh: float = 1e-4,
    grid_size: int = 128,
    occ_skip: Optional[torch.Tensor] = None,
) -> Dict[str, Any]:
    """Occupancy-accelerated render at time t (dnerf run_cuda): march
    through the time slot's bitfield ``occ_bits`` [CAS, H^3] (or, with
    ``occ_skip``, its skip field through the skip walk), then evaluate the
    field on the slab. Depth is normalized as clamp(depth - near) / (far -
    near). Adds ``n_samples`` [N] and ``march_iters``."""
    if perturb and noise is None:
        raise ValueError("perturb=True needs the march jitter draws (noise)")
    aabb = _aabb(cfg, aabb, rays_o.device)
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, min_near)
    common = dict(bound=cfg.bound, dt_gamma=dt_gamma, max_steps=max_steps, slab=slab, grid_size=grid_size,
                  noise=noise if perturb else None)
    if occ_skip is not None:
        m = march_rays_skip(rays_o, rays_d, nears, fars, occ_skip, **common)
    else:
        m = march_rays(rays_o, rays_d, nears, fars, occ_bits, **common)
    xyzs = rays_o[:, None, :] + rays_d[:, None, :] * m.ts[..., None]
    xyzs = torch.maximum(torch.minimum(xyzs, aabb[3:]), aabb[:3])
    sigmas, rgbs, aux = _shade(params, cfg, rays_d, xyzs, t, sigmas_mask=m.valid)
    image, weights_sum, depth = composite_rays_fused(
        sigmas.contiguous(), rgbs.contiguous(), m.dts.contiguous(), m.ts.contiguous(),
        bg_color=1.0 if bg_color is None else bg_color, density_scale=cfg.density_scale, T_thresh=T_thresh,
    )
    depth = torch.clamp(depth - nears, min=0.0) / torch.clamp(fars - nears, min=1e-10)
    out = _result(image, weights_sum, depth, sigmas, aux)
    out.update(n_samples=m.count, march_iters=m.iters)
    return out


@torch.no_grad()
def render_image_dnerf(
    params,
    cfg: DNeRFConfig,
    pose,
    intrinsics,
    H: int,
    W: int,
    t,
    *,
    num_steps: int = 512,
    max_ray_batch: int = 4096,
    bg_color=None,
    aabb=None,
    min_near: float = 0.2,
    occ_bits: Optional[torch.Tensor] = None,
    dt_gamma: float = 0.0,
    max_steps: int = 1024,
    slab: int = 64,
):
    """Full-image render at time t in chunks of ``max_ray_batch`` rays:
    through the occupancy march when ``occ_bits`` (the slot of t) is given,
    else through ``num_steps`` uniform samples. The last chunk is padded with
    rays (o=0, d=+z). Returns (image [H, W, 3], depth [H, W])."""
    device = params["grid"].device
    aabb = _aabb(cfg, aabb, device)
    t = torch.as_tensor(t, dtype=torch.float32, device=device)
    ro, rd = padded_rays(pose, intrinsics, H, W, max_ray_batch, device)
    images, depths = [], []
    for i in range(0, ro.shape[0], max_ray_batch):
        o, d = ro[i : i + max_ray_batch], rd[i : i + max_ray_batch]
        if occ_bits is not None:
            res = render_rays_dnerf_occupancy(params, cfg, o, d, t, occ_bits, dt_gamma=dt_gamma,
                                              max_steps=max_steps, slab=slab, bg_color=bg_color, aabb=aabb,
                                              min_near=min_near)
        else:
            res = render_rays_dnerf(params, cfg, o, d, t, num_steps=num_steps, bg_color=bg_color, aabb=aabb,
                                    min_near=min_near)
        images.append(res["image"])
        depths.append(res["depth"])
    n = H * W
    return torch.cat(images)[:n].reshape(H, W, 3), torch.cat(depths)[:n].reshape(H, W)


class TimeOccupancyState(NamedTuple):
    """Occupancy grid with a time axis (dnerf/renderer.py:74)."""

    density_grid: torch.Tensor  # [T_slots, CAS, H^3] f32
    mean_density: torch.Tensor  # scalar f32, over every slot
    iter_density: torch.Tensor  # scalar i32: slot refreshes so far


def init_time_occupancy(bound: float, device, time_slots: int = 64, grid_size: int = 128) -> TimeOccupancyState:
    return TimeOccupancyState(
        density_grid=torch.zeros((time_slots, cascade_count(bound), grid_size**3), dtype=torch.float32,
                                 device=device),
        mean_density=torch.zeros((), dtype=torch.float32, device=device),
        iter_density=torch.zeros((), dtype=torch.int32, device=device),
    )


@torch.no_grad()
def update_time_occupancy(
    occ: TimeOccupancyState,
    density_eval_t: Callable[[torch.Tensor, float], torch.Tensor],
    draws: Dict[str, torch.Tensor],
    *,
    bound: float,
    time_slot: int,
    density_scale: float = 1.0,
    decay: float = 0.95,
    grid_size: int = 128,
    chunk: int = 2**18,
) -> TimeOccupancyState:
    """Refresh the slot ``time_slot`` (a host int) of the time grid: every
    cell of every cascade, jittered by ``draws["jitter"]`` [CAS, H^3, 3]
    uniforms (``occupancy_draws(..., full=True)``), through
    ``density_eval_t(xyz [M, 3], t) -> sigma [M]`` at the slot's centre time;
    ``max(old * decay, new)`` where both are >= 0. The caller rotates the
    slot, as JAX's trainer does. ``occ.density_grid`` is updated in place
    (the grid is 1 GiB at 64 slots) and returned in a new state with the
    mean over every slot and ``iter_density`` + 1. JAX evaluates 2^15
    points a call; ``chunk`` only changes the batching."""
    t_slots, cas_total, n_cells = occ.density_grid.shape
    device = occ.density_grid.device
    t_val = float(np.float32(time_slot + 0.5) / np.float32(t_slots))  # the slot's centre, in fp32 as JAX
    coords01 = _cell_coords01(torch.arange(n_cells, device=device), grid_size)
    tmp = []
    for cas in range(cas_total):
        cxyz, half = _cascade_world_coords(coords01, cas, bound, grid_size)
        pts = cxyz + (draws["jitter"][cas] * 2.0 - 1.0) * half
        sig = torch.cat([density_eval_t(pts[i : i + chunk], t_val) for i in range(0, n_cells, chunk)])
        tmp.append(sig * density_scale)
    tmp = torch.stack(tmp)  # [CAS, H^3]
    old = occ.density_grid[time_slot]
    valid = (old >= 0) & (tmp >= 0)
    occ.density_grid[time_slot] = torch.where(valid, torch.maximum(old * decay, tmp), old)
    return TimeOccupancyState(
        density_grid=occ.density_grid,
        mean_density=torch.clamp(occ.density_grid, min=0.0).mean(),
        iter_density=occ.iter_density + 1,
    )


def time_slot_of(occ: TimeOccupancyState, t) -> torch.Tensor:
    """The slot of time t, clip(int(t * T_slots), 0, T_slots - 1), as a
    0-d int64 tensor on t's device (no host sync)."""
    t_slots = occ.density_grid.shape[0]
    t = torch.as_tensor(t, dtype=torch.float32, device=occ.density_grid.device)
    return torch.clamp((t * t_slots).to(torch.int64), 0, t_slots - 1)


def time_occupancy_bitfield(occ: TimeOccupancyState, t, density_thresh: float) -> torch.Tensor:
    """Bool [CAS, H^3] of the slot containing time t (dnerf/renderer.py:286):
    density > min(mean over every slot, thresh)."""
    thresh = torch.clamp(occ.mean_density, max=density_thresh)
    return occ.density_grid.index_select(0, time_slot_of(occ, t).reshape(1))[0] > thresh
