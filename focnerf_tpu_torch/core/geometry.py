"""Ray/box and ray/sphere geometry.

Twin of focnerf_tpu/core/geometry.py: ``near_far_from_aabb`` and
``sph_from_ray`` (:24-78; kernel_near_far_from_aabb and kernel_sph_from_ray
of raymarching.cu), ``morton3d`` and ``morton3d_invert`` (:86-115;
__morton3D and __morton3D_invert).
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Sentinel for rays that miss the AABB (the reference uses FLT_MAX).
MISS_T = float(np.float32(3.0e38))


def near_far_from_aabb(rays_o, rays_d, aabb, min_near: float = 0.2):
    """Slab test of rays [..., 3] against aabb [6] -> (nears, fars) [...] f32.

    Missed rays get ``MISS_T`` for both. A box entirely behind the ray gets
    a zero-length segment (far clamped up to near).
    """
    rays_o = rays_o.float()
    rays_d = rays_d.float()
    aabb = torch.as_tensor(aabb, dtype=torch.float32, device=rays_o.device)
    rdir = 1.0 / rays_d  # inf where d == 0: IEEE semantics match CUDA
    t1 = (aabb[:3] - rays_o) * rdir
    t2 = (aabb[3:] - rays_o) * rdir
    tmin = torch.minimum(t1, t2).amax(-1)
    tmax = torch.maximum(t1, t2).amin(-1)
    miss = tmax < tmin
    near = torch.clamp(tmin, min=min_near)
    far = torch.maximum(tmax, near)
    miss_t = torch.full_like(near, MISS_T)
    return torch.where(miss, miss_t, near), torch.where(miss, miss_t, far)


def sph_from_ray(rays_o, rays_d, radius: float):
    """Intersect rays with a background sphere -> (theta, phi) in [-1, 1]."""
    rays_o = rays_o.float()
    rays_d = rays_d.float()
    dot_od = (rays_o * rays_d).sum(-1)
    dot_oo = (rays_o * rays_o).sum(-1)
    disc = torch.clamp(dot_od * dot_od - (dot_oo - radius * radius), min=0.0)
    t = -dot_od + torch.sqrt(disc)
    p = rays_o + t[..., None] * rays_d
    theta = torch.atan2(torch.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2), p[..., 2]) / math.pi
    phi = torch.atan2(p[..., 1], p[..., 0]) / math.pi
    return torch.stack([2.0 * theta - 1.0, phi], dim=-1)


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of each value to every 3rd bit. int64 holds
    the uint32 products whole; each mask keeps only bits JAX's uint32
    arithmetic keeps after its wrap-around."""
    v = v.to(torch.int64)
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    return (v * 0x00000005) & 0x49249249


def morton3d(coords) -> torch.Tensor:
    """Interleave integer coords [..., 3] (each < 1024) into Morton codes [...] int32."""
    coords = torch.as_tensor(coords)
    xx, yy, zz = (_expand_bits(coords[..., i]) for i in range(3))
    return (xx | (yy << 1) | (zz << 2)).to(torch.int32)


def _compact_bits(x: torch.Tensor) -> torch.Tensor:
    x = x & 0x49249249
    x = (x | (x >> 2)) & 0xC30C30C3
    x = (x | (x >> 4)) & 0x0F00F00F
    x = (x | (x >> 8)) & 0xFF0000FF
    return (x | (x >> 16)) & 0x0000FFFF


def morton3d_invert(codes) -> torch.Tensor:
    """Inverse of :func:`morton3d`: codes [...] -> coords [..., 3] int32."""
    codes = torch.as_tensor(codes).to(torch.int64) & 0xFFFFFFFF  # the uint32 view
    return torch.stack([_compact_bits(codes >> s) for s in (0, 1, 2)], dim=-1).to(torch.int32)
