"""Dynamic dense-voxel family: a low-rank time factorization of the raw field.

Twin of focnerf_tpu/train/voxel_dynamic.py:

    raw(x, t) = base(x) + sum_k w_k(t) * delta_k(x),      k = 1..K

where w(t) linearly interpolates learned per-slot weights W [S, K] over
t in [0, 1]. Collapsing at a view's t is one dense einsum; training then
rides ``train/voxel.py``'s engine with the view's time. Regularization: 3D
TV on base and each delta and an L2 smoothness penalty on consecutive time
slots of W. Files are JAX's npz format (``save_dyn_field``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from focnerf_tpu_torch.render.baked import BakedVolume
from focnerf_tpu_torch.train.voxel import field_to_volume, init_voxel_field, tv_loss


class DynVoxelField(NamedTuple):
    """``base`` [R, R, R, C], ``deltas`` [K, R, R, R, C] (C = payload + 1,
    sigma last, pre-activation), ``wslots`` [S, K] mixing weights."""

    base: torch.Tensor
    deltas: torch.Tensor
    wslots: torch.Tensor


def init_dyn_voxel_field(
    resolution: int,
    *,
    rank: int = 4,
    time_slots: int = 16,
    sh_degree: int = 0,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> DynVoxelField:
    """The dense init as base, zero deltas, weights 0.01 (any t reproduces
    the static init)."""
    base = init_voxel_field(resolution, sh_degree, generator=generator, device=device)
    C = base.shape[-1]
    deltas = torch.zeros((rank,) + (resolution,) * 3 + (C,), device=base.device)
    wslots = 0.01 * torch.ones((time_slots, rank), device=base.device)
    return DynVoxelField(base=base, deltas=deltas, wslots=wslots)


def _slot_interp(n_slots: int, t):
    """(i0, f) of the linear interpolation over ``n_slots`` slots at t in
    [0, 1], in fp32 as JAX computes them: host numbers for a float t, 0-d
    device tensors (the same values, no host read) for a tensor t, as the
    fused voxel loop's CUDA graphs pass it."""
    if torch.is_tensor(t):
        x = torch.clamp(t.float(), 0.0, 1.0) * float(n_slots - 1)
        i0 = torch.clamp(torch.floor(x), 0.0, float(n_slots - 2))
        return i0.long(), x - i0
    x = np.float32(np.clip(np.float32(t), 0.0, 1.0)) * np.float32(n_slots - 1)
    i0 = min(max(int(np.floor(x)), 0), n_slots - 2)
    return i0, float(x - np.float32(i0))


def slot_lerp(table: torch.Tensor, dim: int, t) -> torch.Tensor:
    """``table`` linearly interpolated along its slot axis ``dim`` at t in
    [0, 1] (``_slot_interp``), that axis removed."""
    i0, f = _slot_interp(table.shape[dim], t)
    if torch.is_tensor(i0):
        i0 = i0.reshape(1)
        lo, hi = table.index_select(dim, i0).squeeze(dim), table.index_select(dim, i0 + 1).squeeze(dim)
    else:
        lo, hi = table.select(dim, i0), table.select(dim, i0 + 1)
    return (1.0 - f) * lo + f * hi


def time_weights(wslots: torch.Tensor, t) -> torch.Tensor:
    """w(t) by linear interpolation of the S slots over t in [0, 1]."""
    return slot_lerp(wslots, 0, t)


def collapse_field(field: DynVoxelField, t) -> torch.Tensor:
    """raw(x, t): one dense einsum over the rank axis."""
    w = time_weights(field.wslots, t)
    return field.base + torch.einsum("k,kxyzc->xyzc", w, field.deltas)


def dyn_reg(field: DynVoxelField, tv_weight: float, time_smooth_weight: float) -> torch.Tensor:
    """3D TV on base and each delta + L2 smoothness on consecutive slots."""
    delta_tv = torch.stack([tv_loss(d) for d in field.deltas]).mean()
    r = tv_weight * (tv_loss(field.base) + delta_tv)
    dw = torch.diff(field.wslots, dim=0)
    return r + time_smooth_weight * torch.mean(dw * dw)


def dyn_field_to_volume(field: DynVoxelField, t, bound: float, sh_degree: int = 0) -> BakedVolume:
    return field_to_volume(collapse_field(field, t), bound, sh_degree)


def save_dyn_field(path: str, field: DynVoxelField, bound: float, sh_degree: int) -> None:
    """JAX's npz: float16 base and deltas, float32 slot weights."""
    np.savez_compressed(
        path,
        base=field.base.detach().cpu().numpy().astype(np.float16),
        deltas=field.deltas.detach().cpu().numpy().astype(np.float16),
        wslots=field.wslots.detach().cpu().numpy().astype(np.float32),
        bound=np.float32(bound),
        sh_deg=np.int32(sh_degree),
    )


def load_dyn_field(path: str, device=None) -> Tuple[DynVoxelField, float, int]:
    from focnerf_tpu_torch import resolve_device

    device = resolve_device(device)
    to = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    with np.load(path) as z:
        field = DynVoxelField(base=to(z["base"]), deltas=to(z["deltas"]), wslots=to(z["wslots"]))
        return field, float(z["bound"]), int(z["sh_deg"])


def fit_dyn_voxels(
    poses: np.ndarray,
    images,
    times: np.ndarray,  # [V] in [0, 1]
    intrinsics: Sequence[float],
    *,
    resolution: int = 128,
    rank: int = 4,
    time_slots: int = 16,
    bound: float = 1.0,
    sh_degree: int = 0,
    iters: int = 500,
    lr: float = 5e-2,
    tv_weight: float = 1e-4,
    time_smooth_weight: float = 1e-3,
    bg_color: float = 1.0,
    density_scale: float = 1.0,
    seed: int = 0,
    log_every: int = 0,
    remat: bool = True,
    steps_per_dispatch: int = 1,
    device=None,
) -> Tuple[DynVoxelField, Dict]:
    """Fit the dynamic field to (pose, image, t) triples (intermediate-plane
    supervision). Returns (field, info)."""
    from focnerf_tpu_torch.train.voxel import _fit_field_loop

    field = init_dyn_voxel_field(resolution, rank=rank, time_slots=time_slots, sh_degree=sh_degree,
                                 generator=torch.Generator().manual_seed(seed), device=device)
    return _fit_field_loop(
        poses, images, intrinsics,
        params=field,
        raw_fn=collapse_field,  # collapse at the view's own t
        reg_fn=lambda f: dyn_reg(f, tv_weight, time_smooth_weight),
        resolution=resolution, bound=bound, sh_degree=sh_degree, iters=iters, lr=lr, bg_color=bg_color,
        density_scale=density_scale, seed=seed, log_every=log_every, remat=remat, times=times,
        tag="dynvoxel", steps_per_dispatch=steps_per_dispatch,
    )


def make_dyn_dp_step(
    mesh,
    intrinsics: Sequence[float],
    *,
    H: int,
    W: int,
    resolution: int,
    warp_axis: int,
    flip: bool,
    tv_weight: float = 1e-4,
    time_smooth_weight: float = 1e-3,
    **kw,
):
    """Pose-parallel DP step of the low-rank dynamic family: each rank
    collapses the field at its own views' times (the time-conditioned
    ``make_voxel_dp_step``); step(state, poses, times, targets, masks)."""
    from focnerf_tpu_torch.train.voxel import make_voxel_dp_step

    return make_voxel_dp_step(
        mesh, intrinsics, H=H, W=W, resolution=resolution, warp_axis=warp_axis, flip=flip,
        collapse_fn=collapse_field, reg_fn=lambda f: dyn_reg(f, tv_weight, time_smooth_weight),
        time_conditioned=True, **kw,
    )
