"""K-planes dynamic field: a six-plane space-time factorization.

Twin of focnerf_tpu/train/voxel_kplanes.py (Fridovich-Keil et al., CVPR
2023): six rank-K planes over every axis pair,

    raw(x, y, z, t, c) = w_c * sum_r  P_xy[x,y,r,c] * P_xz[x,z,r,c]
                                    * P_yz[y,z,r,c] * P_xt[x,t,r,c]
                                    * P_yt[y,t,r,c] * P_zt[z,t,r,c]
                       + b_c

Collapsing at a fixed t interpolates the three time planes into per-axis
vectors, folds them into two spatial planes and accumulates the rank-k
triple products one k at a time into one [R, R, R, C] buffer (in JAX's
order of sums); training then rides ``train/voxel.py``'s engine.
Regularization: 2D TV on all six planes and a second-difference smoothness
along the time axis. Files are JAX's npz format (``save_kplanes_field``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from focnerf_tpu_torch.render.baked import BakedVolume
from focnerf_tpu_torch.train.voxel import field_to_volume, payload_channels
from focnerf_tpu_torch.train.voxel_dynamic import slot_lerp


class KPlanesField(NamedTuple):
    """``space`` [3, R, R, K, C] (xy, xz, yz), ``time`` [3, R, T, K, C] (xt,
    yt, zt), ``w`` [C] output scale, ``b`` [C] output bias (sigma last,
    pre-activation)."""

    space: torch.Tensor
    time: torch.Tensor
    w: torch.Tensor
    b: torch.Tensor


def init_kplanes_field(
    resolution: int,
    *,
    rank: int = 8,
    time_res: int = 16,
    sh_degree: int = 0,
    raw_sigma0: float = -3.0,
    init_scale: float = 0.1,
    w0: float = 0.05,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> KPlanesField:
    """Planes at 1 + init_scale N(0, 1) from ``generator`` (a CPU generator;
    None: seed 0); the affine head starts raw at ~(0, ..., raw_sigma0)."""
    from focnerf_tpu_torch import resolve_device

    device = resolve_device(device)
    C = payload_channels(sh_degree) + 1
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    R, T, K = resolution, time_res, rank
    space = 1.0 + init_scale * torch.randn((3, R, R, K, C), generator=g)
    time_ = 1.0 + init_scale * torch.randn((3, R, T, K, C), generator=g)
    w = torch.full((C,), w0)
    b = torch.full((C,), -w0 * K)
    b[-1] += raw_sigma0
    return KPlanesField(space=space.to(device), time=time_.to(device), w=w.to(device), b=b.to(device))


def _time_vectors(time_planes: torch.Tensor, t) -> torch.Tensor:
    """The [3, R, T, K, C] time planes at t in [0, 1] -> per-axis vectors
    [3, R, K, C] (linear over the T slots)."""
    return slot_lerp(time_planes, 2, t)


def collapse_kplanes(field: KPlanesField, t) -> torch.Tensor:
    """Factors at time t -> dense raw grid [R, R, R, C]."""
    v = _time_vectors(field.time, t)  # vx, vy, vz
    A = field.space[0] * v[0][:, None] * v[1][None, :]  # xy * vx * vy
    B = field.space[1] * v[2][None, :]  # xz * vz
    Cp = field.space[2]  # yz
    g = None
    for k in range(A.shape[2]):
        term = A[:, :, k][:, :, None] * B[:, :, k][:, None, :] * Cp[:, :, k][None]
        g = term if g is None else g + term
    return field.w * g + field.b


def kplanes_field_to_volume(field: KPlanesField, t, bound: float, sh_degree: int = 0) -> BakedVolume:
    return field_to_volume(collapse_kplanes(field, t), bound, sh_degree)


def kplanes_tv_loss(field: KPlanesField) -> torch.Tensor:
    """2D TV on all six planes (both axes of each plane)."""
    tv = 0.0
    for planes in (field.space, field.time):
        for ax in (1, 2):
            d = torch.diff(planes, dim=ax)
            tv = tv + torch.mean(d * d)
    return tv


def kplanes_time_smoothness(field: KPlanesField) -> torch.Tensor:
    """Second-difference smoothness along the t axis of the time planes."""
    d2 = torch.diff(field.time, n=2, dim=2)
    return torch.mean(d2 * d2)


def kplanes_reg(field: KPlanesField, tv_weight: float, time_smooth_weight: float) -> torch.Tensor:
    return tv_weight * kplanes_tv_loss(field) + time_smooth_weight * kplanes_time_smoothness(field)


def upsample_kplanes(field: KPlanesField, new_res: int) -> KPlanesField:
    """Bilinearly upsample the spatial axes of the six planes (half-pixel
    centres, as ``jax.image.resize``); the time resolution stays."""
    _, R, _, K, C = field.space.shape
    T = field.time.shape[2]
    s = field.space.permute(0, 3, 4, 1, 2).reshape(3 * K * C, 1, R, R)
    s = F.interpolate(s, size=(new_res, new_res), mode="bilinear", align_corners=False)
    space = s.reshape(3, K, C, new_res, new_res).permute(0, 3, 4, 1, 2).contiguous()
    tm = field.time.permute(0, 3, 4, 1, 2).reshape(3 * K * C, 1, R, T)
    tm = F.interpolate(tm, size=(new_res, T), mode="bilinear", align_corners=False)
    time_ = tm.reshape(3, K, C, new_res, T).permute(0, 3, 4, 1, 2).contiguous()
    return KPlanesField(space=space, time=time_, w=field.w, b=field.b)


def save_kplanes_field(path: str, field: KPlanesField, bound: float, sh_degree: int) -> None:
    """JAX's npz: float16 planes, float32 head."""
    host = lambda a: a.detach().cpu().numpy()  # noqa: E731
    np.savez_compressed(
        path,
        space=host(field.space).astype(np.float16),
        time=host(field.time).astype(np.float16),
        w=host(field.w).astype(np.float32),
        b=host(field.b).astype(np.float32),
        bound=np.float32(bound),
        sh_deg=np.int32(sh_degree),
    )


def load_kplanes_field(path: str, device=None) -> Tuple[KPlanesField, float, int]:
    from focnerf_tpu_torch import resolve_device

    device = resolve_device(device)
    to = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    with np.load(path) as z:
        field = KPlanesField(space=to(z["space"]), time=to(z["time"]), w=to(z["w"]), b=to(z["b"]))
        return field, float(z["bound"]), int(z["sh_deg"])


def fit_kplanes(
    poses: np.ndarray,
    images,
    times: np.ndarray,  # [V] in [0, 1]
    intrinsics: Sequence[float],
    *,
    resolution: int = 128,
    rank: int = 8,
    time_res: int = 16,
    bound: float = 1.0,
    sh_degree: int = 0,
    iters: int = 500,
    lr: float = 2e-2,
    tv_weight: float = 1e-4,
    time_smooth_weight: float = 1e-3,
    bg_color: float = 1.0,
    density_scale: float = 1.0,
    init_field: Optional[KPlanesField] = None,
    seed: int = 0,
    log_every: int = 0,
    remat: bool = True,
    steps_per_dispatch: int = 1,
    device=None,
) -> Tuple[KPlanesField, Dict]:
    """Fit the K-planes field to (pose, image, t) triples through the
    shared engine. Returns (field, info)."""
    from focnerf_tpu_torch.train.voxel import _fit_field_loop

    field = init_field
    if field is None:
        field = init_kplanes_field(resolution, rank=rank, time_res=time_res, sh_degree=sh_degree,
                                   generator=torch.Generator().manual_seed(seed), device=device)
    return _fit_field_loop(
        poses, images, intrinsics,
        params=field,
        raw_fn=collapse_kplanes,  # collapse at the view's own t
        reg_fn=lambda f: kplanes_reg(f, tv_weight, time_smooth_weight),
        resolution=resolution, bound=bound, sh_degree=sh_degree, iters=iters, lr=lr, bg_color=bg_color,
        density_scale=density_scale, seed=seed, log_every=log_every, remat=remat, times=times,
        tag="kplanes", steps_per_dispatch=steps_per_dispatch,
    )


def fit_kplanes_c2f(
    poses: np.ndarray,
    images,
    times: np.ndarray,
    intrinsics: Sequence[float],
    *,
    resolution: int = 128,
    stages: int = 3,
    iters: int = 500,
    seed: int = 0,
    log_every: int = 0,
    **kw,
) -> Tuple[KPlanesField, Dict]:
    """Coarse-to-fine K-planes fit on the shared ladder, each stage seeded
    with ``upsample_kplanes`` of the previous factors."""
    from focnerf_tpu_torch.train.voxel import _c2f_stage_plan

    field = None
    stage_psnrs = []
    info: Dict = {}
    for si, (R, n_it) in enumerate(_c2f_stage_plan(resolution, stages, iters)):
        if field is not None:
            field = upsample_kplanes(field, R)
        field, info = fit_kplanes(poses, images, times, intrinsics, resolution=R, iters=n_it, init_field=field,
                                  seed=seed + si, log_every=log_every, **kw)
        stage_psnrs.append(info["psnr"])
    info["stage_psnrs"] = stage_psnrs
    return field, info


def make_kplanes_dp_step(
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
    """Pose-parallel DP step of the K-planes family: each rank collapses the
    six planes at its own views' times (the time-conditioned
    ``make_voxel_dp_step``); step(state, poses, times, targets, masks)."""
    from focnerf_tpu_torch.train.voxel import make_voxel_dp_step

    return make_voxel_dp_step(
        mesh, intrinsics, H=H, W=W, resolution=resolution, warp_axis=warp_axis, flip=flip,
        collapse_fn=collapse_kplanes, reg_fn=lambda f: kplanes_reg(f, tv_weight, time_smooth_weight),
        time_conditioned=True, **kw,
    )
