"""VM-factorized dense field: TensoRF-style planes x vectors.

Twin of focnerf_tpu/train/voxel_vm.py. The raw field is

    raw[x, y, z, c] = bias[c]
                    + sum_k P0[y, z, k, c] * V0[x, k, c]     (YZ plane x X vector)
                    + sum_k P1[x, z, k, c] * V1[y, k, c]     (XZ plane x Y vector)
                    + sum_k P2[x, y, k, c] * V2[z, k, c]     (XY plane x Z vector)

with R/(3K) fewer parameters than the dense grid. Collapsing is three
dense einsums; training then rides ``train/voxel.py``'s engine unchanged.
Regularization: 2D TV on the planes, 1D TV on the vectors, optional L1 on
the density factors. Files are JAX's npz format (``save_vm_field``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from focnerf_tpu_torch.render.baked import BakedVolume
from focnerf_tpu_torch.train.voxel import field_to_volume, payload_channels


class VMField(NamedTuple):
    """Factorized raw field. ``planes`` [3, R, R, K, C], ``vectors``
    [3, R, K, C], ``bias`` [C]; C = payload channels + 1 (sigma last,
    pre-activation)."""

    planes: torch.Tensor
    vectors: torch.Tensor
    bias: torch.Tensor


def init_vm_field(
    resolution: int,
    *,
    rank: int = 16,
    sh_degree: int = 0,
    raw_sigma0: float = -3.0,
    init_scale: float = 0.1,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> VMField:
    """Factors ~ N(0, init_scale) from ``generator`` (a CPU generator; None:
    seed 0), the sigma bias at raw_sigma0, on ``device`` (None: ``cuda``)."""
    from focnerf_tpu_torch import resolve_device

    device = resolve_device(device)
    C = payload_channels(sh_degree) + 1
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    R = resolution
    planes = init_scale * torch.randn((3, R, R, rank, C), generator=g)
    vectors = init_scale * torch.randn((3, R, rank, C), generator=g)
    bias = torch.zeros(C)
    bias[-1] = raw_sigma0
    return VMField(planes=planes.to(device), vectors=vectors.to(device), bias=bias.to(device))


def collapse_vm(field: VMField) -> torch.Tensor:
    """Factors -> dense raw grid [R, R, R, C]: three einsums."""
    P, V = field.planes, field.vectors
    g = torch.einsum("yzkc,xkc->xyzc", P[0], V[0])
    g = g + torch.einsum("xzkc,ykc->xyzc", P[1], V[1])
    g = g + torch.einsum("xykc,zkc->xyzc", P[2], V[2])
    return g + field.bias


def vm_field_to_volume(field: VMField, bound: float, sh_degree: int = 0) -> BakedVolume:
    return field_to_volume(collapse_vm(field), bound, sh_degree)


def vm_tv_loss(field: VMField) -> torch.Tensor:
    """Factored total variation: 2D TV on each plane stack, 1D on vectors."""
    tv = 0.0
    for ax in (1, 2):  # the two spatial axes of [3, R, R, K, C]
        d = torch.diff(field.planes, dim=ax)
        tv = tv + torch.mean(d * d)
    dv = torch.diff(field.vectors, dim=1)
    return tv + torch.mean(dv * dv)


def vm_density_l1(field: VMField) -> torch.Tensor:
    """L1 sparsity on the density component's factors (TensoRF prior)."""
    return torch.mean(torch.abs(field.planes[..., -1])) + torch.mean(torch.abs(field.vectors[..., -1]))


def vm_reg(field: VMField, tv_weight: float, l1_weight: float) -> torch.Tensor:
    r = tv_weight * vm_tv_loss(field)
    if l1_weight > 0.0:
        r = r + l1_weight * vm_density_l1(field)
    return r


def upsample_vm(field: VMField, new_res: int) -> VMField:
    """Bilinearly upsample the factors (half-pixel centres, as
    ``jax.image.resize``'s bilinear/linear)."""
    _, R, _, K, C = field.planes.shape
    p = field.planes.permute(0, 3, 4, 1, 2).reshape(3 * K * C, 1, R, R)
    p = F.interpolate(p, size=(new_res, new_res), mode="bilinear", align_corners=False)
    planes = p.reshape(3, K, C, new_res, new_res).permute(0, 3, 4, 1, 2).contiguous()
    v = field.vectors.permute(0, 2, 3, 1).reshape(3 * K * C, 1, R)
    v = F.interpolate(v, size=new_res, mode="linear", align_corners=False)
    vectors = v.reshape(3, K, C, new_res).permute(0, 3, 1, 2).contiguous()
    return VMField(planes=planes, vectors=vectors, bias=field.bias)


def save_vm_field(path: str, field: VMField, bound: float, sh_degree: int) -> None:
    """JAX's npz: float16 factors, float32 bias."""
    np.savez_compressed(
        path,
        planes=field.planes.detach().cpu().numpy().astype(np.float16),
        vectors=field.vectors.detach().cpu().numpy().astype(np.float16),
        bias=field.bias.detach().cpu().numpy().astype(np.float32),
        bound=np.float32(bound),
        sh_deg=np.int32(sh_degree),
    )


def load_vm_field(path: str, device=None) -> Tuple[VMField, float, int]:
    from focnerf_tpu_torch import resolve_device

    device = resolve_device(device)
    to = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    with np.load(path) as z:
        field = VMField(planes=to(z["planes"]), vectors=to(z["vectors"]), bias=to(z["bias"]))
        return field, float(z["bound"]), int(z["sh_deg"])


def fit_vm_voxels(
    poses: np.ndarray,
    images,
    intrinsics: Sequence[float],
    *,
    resolution: int = 128,
    rank: int = 16,
    bound: float = 1.0,
    sh_degree: int = 0,
    iters: int = 500,
    lr: float = 2e-2,
    tv_weight: float = 1e-4,
    l1_weight: float = 0.0,
    bg_color: float = 1.0,
    density_scale: float = 1.0,
    init_field: Optional[VMField] = None,
    seed: int = 0,
    log_every: int = 0,
    intermediate_scale: int = 2,
    remat: bool = True,
    steps_per_dispatch: int = 1,
    device=None,
) -> Tuple[BakedVolume, Dict]:
    """Fit the VM field (intermediate-plane supervision), warm-started from
    ``init_field`` when given. Returns (volume, info); info["field"] holds
    the factors."""
    from focnerf_tpu_torch.train.voxel import _fit_field_loop

    field = init_field
    if field is None:
        field = init_vm_field(resolution, rank=rank, sh_degree=sh_degree,
                              generator=torch.Generator().manual_seed(seed), device=device)
    field, info = _fit_field_loop(
        poses, images, intrinsics,
        params=field,
        raw_fn=lambda f, t: collapse_vm(f),
        reg_fn=lambda f: vm_reg(f, tv_weight, l1_weight),
        resolution=resolution, bound=bound, sh_degree=sh_degree, iters=iters, lr=lr, bg_color=bg_color,
        density_scale=density_scale, seed=seed, log_every=log_every, intermediate_scale=intermediate_scale,
        remat=remat, tag="vmvoxel", steps_per_dispatch=steps_per_dispatch,
    )
    info["field"] = field
    return vm_field_to_volume(field, bound, sh_degree), info


def fit_vm_c2f(
    poses: np.ndarray,
    images,
    intrinsics: Sequence[float],
    *,
    resolution: int = 128,
    stages: int = 3,
    iters: int = 500,
    seed: int = 0,
    log_every: int = 0,
    **kw,
) -> Tuple[BakedVolume, Dict]:
    """Coarse-to-fine VM fit on the shared ladder, each stage seeded with
    ``upsample_vm`` of the previous factors."""
    from focnerf_tpu_torch.train.voxel import _c2f_stage_plan

    field = None
    stage_psnrs = []
    info: Dict = {}
    vol = None
    for si, (R, n_it) in enumerate(_c2f_stage_plan(resolution, stages, iters)):
        if field is not None:
            field = upsample_vm(field, R)
        vol, info = fit_vm_voxels(poses, images, intrinsics, resolution=R, iters=n_it, init_field=field,
                                  seed=seed + si, log_every=log_every, **kw)
        stage_psnrs.append(info["psnr"])
        field = info["field"]
    info["stage_psnrs"] = stage_psnrs
    return vol, info


def make_vm_dp_step(
    mesh,
    intrinsics: Sequence[float],
    *,
    H: int,
    W: int,
    resolution: int,
    warp_axis: int,
    flip: bool,
    tv_weight: float = 1e-4,
    l1_weight: float = 0.0,
    **kw,
):
    """Pose-parallel DP step of the VM family: ``make_voxel_dp_step`` with the
    factors replicated on every rank and collapsed inside each rank's loss."""
    from focnerf_tpu_torch.train.voxel import make_voxel_dp_step

    return make_voxel_dp_step(
        mesh, intrinsics, H=H, W=W, resolution=resolution, warp_axis=warp_axis, flip=flip,
        collapse_fn=collapse_vm, reg_fn=lambda f: vm_reg(f, tv_weight, l1_weight), **kw,
    )
