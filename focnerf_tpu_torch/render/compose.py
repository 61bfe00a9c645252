"""Multi-object scene composition and rigid editing.

Twin of focnerf_tpu/render/compose.py (the reference's COMBINED.py:141-251,
592-618 and editable.py:443-471):

  - every object's field is evaluated along shared rays, and the fields are
    fused per sample by max density (sigma = max_k sigma_k, rgb of the
    argmax object; strict ``>``, so on equal sigma the earlier object wins
    and a sample where no object has sigma > 0 keeps rgb 0), then
    composited to RGBA (alpha is the weights' sum);
  - an edit queries object k at ``(x + offset_k) @ R_k``: a rigid
    translation by -offset_k and a rotation of the object in the scene;
  - ``compose_rays`` samples ``num_steps`` uniform steps between the
    un-offset rays' near and far; ``compose_rays_occupancy`` marches once
    on the scene-space union of the objects' occupancy bitfields
    (``union_occupancy_bits``) and folds the fields over that slab.

The K objects' params are loaded once and stay on the device; a Python loop
over them replaces ``lax.scan`` and keeps only the running (max sigma, rgb)
of a chunk, so memory is O(chunk x samples) whatever K is. Both paths
composite through ``ops/composite.py::composite_rays_fused`` without
gradients: on CUDA tensors that is the forward kernel of
``csrc/composite.cu``, which computes the JAX package's ``composite_rays``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from focnerf_tpu_torch.core.geometry import near_far_from_aabb
from focnerf_tpu_torch.models.nerf import NeRFConfig, color_fn, density_fn, encode_objfeat
from focnerf_tpu_torch.ops.composite import composite_rays_fused
from focnerf_tpu_torch.ops.marching import march_rays
from focnerf_tpu_torch.render.renderer import _aabb, padded_rays


def stack_object_params(params_list) -> List[dict]:
    """K param dicts of one structure, on one device -> the list the
    compositor folds over (the twin of JAX's stacked [K, ...] pytree; the
    tables are not copied)."""
    params_list = list(params_list)
    if not params_list:
        raise ValueError("stack_object_params needs at least one object")
    keys, device = set(params_list[0]), params_list[0]["grid"].device
    for p in params_list[1:]:
        if set(p) != keys or p["grid"].shape != params_list[0]["grid"].shape:
            raise ValueError("composed objects must share one parameter structure")
        if p["grid"].device != device:
            raise ValueError("composed objects must live on one device")
    return params_list


def _translate_zero3(g: torch.Tensor, shift) -> torch.Tensor:
    """Translate a [H, H, H] grid by whole cells per axis, ``out[i] =
    g[i - shift]``, zero where ``i - shift`` leaves the grid (JAX's
    ``_roll_zero3``: a roll whose wrapped-in region is zeroed)."""
    H = g.shape[0]
    out = torch.zeros_like(g)
    src, dst = [], []
    for s in shift:
        s = int(s)
        if abs(s) >= H:
            return out
        src.append(slice(max(0, -s), H - max(0, s)))
        dst.append(slice(max(0, s), H - max(0, -s)))
    out[tuple(dst)] = g[tuple(src)]
    return out


def union_occupancy_bits(
    stacked_bits: torch.Tensor,  # [K, CAS, H^3] bool, per-object bitfields
    offsets=None,  # [K, 3] rigid edit translations (or None)
    bound: float = 1.0,
    grid_size: int = 128,
) -> torch.Tensor:
    """Scene-space union [CAS, H^3] of the objects' bitfields.

    Object k's field is queried at x + offset_k, so in the scene its
    occupied cells move by -offset_k: ``round(-offset / cell)`` whole cells
    of cascade c, cell = 2 * min(2^c, bound) / grid_size (round half to
    even, as ``jnp.round``), zero-filled where the grid moves in. The
    marcher only needs a conservative skip mask; compositing stays exact.
    """
    if offsets is None:
        return stacked_bits.any(0)
    offsets = torch.as_tensor(offsets, dtype=torch.float32).cpu().numpy()
    K, cas_total, _ = stacked_bits.shape
    out = []
    for cas in range(cas_total):
        cell = np.float32(2.0 * min(2.0**cas, float(bound)) / grid_size)
        shifts = np.round(-offsets / cell).astype(np.int64)  # an fp32 quotient, as JAX's
        grids = stacked_bits[:, cas].reshape(K, grid_size, grid_size, grid_size)
        shifted = [_translate_zero3(grids[k], shifts[k]) for k in range(K)]
        out.append(torch.stack(shifted).any(0).reshape(-1))
    return torch.stack(out)


def rotation_matrices(rotations_deg, device="cpu") -> torch.Tensor:
    """Per-object rotation matrices [K, 3, 3] from per-axis degrees [K, 3]:
    right-handed, applied x, then y, then z. Row-vector convention: a scene
    point queries object k at ``(x + offset_k) @ R_k``, and for an
    orthonormal R, ``x_row @ R == (R^-1 x)_col``, which places the object
    rotated by +deg in the scene."""
    out = []
    for rx, ry, rz in np.asarray(rotations_deg, np.float32):
        R = np.eye(3, dtype=np.float32)
        for ax, dg in ((0, rx), (1, ry), (2, rz)):
            th = np.deg2rad(float(dg))
            c, s = np.cos(th), np.sin(th)
            # the in-plane pair about +ax is the cyclic one: about +y it is
            # (z, x); the ascending (x, z) would negate the rotation
            i, j = ((1, 2), (2, 0), (0, 1))[ax]
            A = np.eye(3, dtype=np.float32)
            A[i, i] = c
            A[j, j] = c
            A[i, j] = -s
            A[j, i] = s
            R = A @ R
        out.append(R)
    return torch.from_numpy(np.stack(out)).to(device)


def _f32(a, device):
    """None, or ``a`` as a float32 tensor on ``device``."""
    return None if a is None else torch.as_tensor(a, dtype=torch.float32, device=device)


def _fold_objects(stacked_params, cfg: NeRFConfig, rays_o, rays_d, ts, aabb, obj_feats,
                  offsets, rots, valid=None):
    """The running per-sample (max sigma, rgb of the argmax object) over the
    K objects at positions ``o + d * ts`` [N, T] -> (sigma [N, T], rgb [N, T, 3])."""
    if obj_feats is None and cfg.use_objfeat:
        raise ValueError("cfg.use_objfeat=True requires per-object obj_feats [K, F]")
    device = rays_o.device
    obj_feats, offsets, rots = (_f32(a, device) for a in (obj_feats, offsets, rots))
    n, t = ts.shape
    best_sigma = torch.zeros((n, t), dtype=torch.float32, device=device)
    best_rgb = torch.zeros((n, t, 3), dtype=torch.float32, device=device)
    dirs = rays_d[:, None, :].expand(n, t, 3)
    for k, params_k in enumerate(stacked_params):
        # translate by shifting the ray origins; rotate by mapping the sample
        # points and view directions into the object's frame (without a
        # rotation nothing is multiplied: x @ I changes no bit)
        o_k = rays_o if offsets is None else rays_o + offsets[k][None, :]
        xyzs = o_k[:, None, :] + rays_d[:, None, :] * ts[..., None]
        dirs_k = dirs
        if rots is not None:
            xyzs = xyzs @ rots[k]
            dirs_k = dirs @ rots[k]
        xyzs = torch.maximum(torch.minimum(xyzs, aabb[3:]), aabb[:3])
        sigma_k, geo_k = density_fn(params_k, cfg, xyzs)
        if valid is not None:
            sigma_k = torch.where(valid, sigma_k, torch.zeros_like(sigma_k))
        enc = encode_objfeat(params_k, cfg, obj_feats[k]) if cfg.use_objfeat else None
        rgb_k = color_fn(params_k, cfg, dirs_k, geo_k, enc)
        take = sigma_k > best_sigma  # max-density argmax selection (COMBINED.py:247-251)
        best_sigma = torch.where(take, sigma_k, best_sigma)
        best_rgb = torch.where(take[..., None], rgb_k, best_rgb)
    return best_sigma, best_rgb


@torch.no_grad()
def compose_rays(
    stacked_params,
    cfg: NeRFConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    obj_feats=None,  # [K, F] per-object conditioning
    offsets=None,  # [K, 3] rigid edit translations
    rots=None,  # [K, 3, 3] rigid edit rotations
    *,
    num_steps: int = 512,
    bg_color=1.0,
    aabb=None,
    min_near: float = 0.2,
) -> Dict[str, Any]:
    """Max-density composition of one ray chunk over ``num_steps`` uniform
    samples -> dict(image [N, 3], depth [N], alpha [N])."""
    aabb = _aabb(cfg, aabb, rays_o.device)
    # one sample lattice for every object, from the un-offset rays
    # (editable.py caches the first object's rays for the others, :443-471)
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, min_near)
    z = torch.linspace(0.0, 1.0, num_steps, dtype=torch.float32, device=rays_o.device)[None, :]
    z_vals = nears[:, None] + (fars - nears)[:, None] * z
    sample_dist = (fars - nears)[:, None] / num_steps
    deltas = torch.cat([z_vals[..., 1:] - z_vals[..., :-1], sample_dist], dim=-1)
    sigma, rgb = _fold_objects(stacked_params, cfg, rays_o, rays_d, z_vals, aabb, obj_feats,
                               offsets, rots)
    ori_z = torch.clamp((z_vals - nears[:, None]) / torch.clamp(fars - nears, min=1e-10)[:, None], 0.0, 1.0)
    image, weights_sum, depth = composite_rays_fused(
        sigma, rgb, deltas.contiguous(), ori_z.contiguous(), bg_color=bg_color,
        density_scale=cfg.density_scale, T_thresh=0.0,
    )
    return {"image": image, "depth": depth, "alpha": weights_sum}


@torch.no_grad()
def compose_rays_occupancy(
    stacked_params,
    cfg: NeRFConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    occ_bits: torch.Tensor,  # [CAS, H^3] scene-space union bitfield
    obj_feats=None,
    offsets=None,
    rots=None,
    *,
    dt_gamma: float = 0.0,
    max_steps: int = 1024,
    slab: int = 64,
    bg_color=1.0,
    aabb=None,
    min_near: float = 0.2,
    T_thresh: float = 1e-4,
    grid_size: int = 128,
) -> Dict[str, Any]:
    """Occupancy-accelerated composition of one ray chunk: one march on the
    union bitfield, the K fields folded over its slab, early-terminated
    compositing. Depth is clamp(depth - near, 0) / (far - near)."""
    aabb = _aabb(cfg, aabb, rays_o.device)
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, min_near)
    m = march_rays(rays_o, rays_d, nears, fars, occ_bits, bound=cfg.bound, dt_gamma=dt_gamma,
                   max_steps=max_steps, slab=slab, grid_size=grid_size)
    sigma, rgb = _fold_objects(stacked_params, cfg, rays_o, rays_d, m.ts, aabb, obj_feats,
                               offsets, rots, valid=m.valid)
    image, weights_sum, depth = composite_rays_fused(
        sigma, rgb, m.dts.contiguous(), m.ts.contiguous(), bg_color=bg_color,
        density_scale=cfg.density_scale, T_thresh=T_thresh,
    )
    depth = torch.clamp(depth - nears, min=0.0) / torch.clamp(fars - nears, min=1e-10)
    return {"image": image, "depth": depth, "alpha": weights_sum}


@torch.no_grad()
def compose_image(
    stacked_params,
    cfg: NeRFConfig,
    pose,
    intrinsics,
    H: int,
    W: int,
    obj_feats=None,
    offsets=None,
    rots=None,  # [K, 3, 3] rigid edit rotations (rotation_matrices)
    *,
    num_steps: int = 512,
    max_ray_batch: int = 4096,
    bg_color=1.0,
    aabb=None,
    min_near: float = 0.2,
    occ_bits: Optional[torch.Tensor] = None,
    dt_gamma: float = 0.0,
    max_steps: int = 1024,
    slab: int = 64,
):
    """Full-image composition in chunks of ``max_ray_batch`` rays (the last
    padded with rays o = 0, d = +z) -> (rgba [H, W, 4], depth [H, W]) on the
    objects' device. With ``occ_bits`` (a union bitfield) the rays march
    through occupied space only, else they take ``num_steps`` uniform steps."""
    device = stacked_params[0]["grid"].device
    # once: a per-chunk host copy would sync
    aabb = _aabb(cfg, aabb, device)
    edits = dict(obj_feats=_f32(obj_feats, device), offsets=_f32(offsets, device), rots=_f32(rots, device))
    ro, rd = padded_rays(pose, intrinsics, H, W, max_ray_batch, device)
    n = H * W
    images, depths, alphas = [], [], []
    for i in range(0, ro.shape[0], max_ray_batch):
        o, d = ro[i : i + max_ray_batch], rd[i : i + max_ray_batch]
        if occ_bits is not None:
            res = compose_rays_occupancy(
                stacked_params, cfg, o, d, occ_bits, **edits, dt_gamma=dt_gamma,
                max_steps=max_steps, slab=slab, bg_color=bg_color, aabb=aabb, min_near=min_near,
            )
        else:
            res = compose_rays(stacked_params, cfg, o, d, **edits, num_steps=num_steps,
                               bg_color=bg_color, aabb=aabb, min_near=min_near)
        images.append(res["image"])
        depths.append(res["depth"])
        alphas.append(res["alpha"])
    rgba = torch.cat([torch.cat(images)[:n], torch.cat(alphas)[:n, None]], -1).reshape(H, W, 4)
    return rgba, torch.cat(depths)[:n].reshape(H, W)
