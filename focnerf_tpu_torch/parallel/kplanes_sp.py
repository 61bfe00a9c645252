"""Collapse-sharded slice parallelism for the K-planes dynamic family.

Twin of focnerf_tpu/parallel/kplanes_sp.py. What fills the device at
dynamic resolutions of 512^3 and up is not the six rank-K planes but the
collapsed [R, R, R, C] grid the shear-warp fold consumes, and its autograd
residuals. So each rank collapses only its own warp-axis slab of the grid,
straight from the planes (``train/voxel_kplanes.py::collapse_kplanes``'s
rank-k accumulation restricted to the rank's rows), folds it, and the
slabs combine in optical-depth space as the dense SP step's do
(``parallel/voxel_sp.py::_sp_slab_strip_mse``, shared).

The planes and their Adam moments are replicated (they are two orders of
magnitude below the collapsed grid): a pose-variant switch never moves
state. One all-reduce a step SUMs the ranks' shares of the plane gradient,
and the family regularizer (plane TV and time smoothness) is added once,
after the sum, as JAX evaluates it outside its ``shard_map``
(``parallel/vm_sp.py`` has the same design).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from focnerf_tpu_torch.parallel.voxel_sp import _fit_replicated_sp_loop, _make_factor_sp_step
from focnerf_tpu_torch.train.voxel_kplanes import KPlanesField, _time_vectors, kplanes_reg


def _collapse_local_slab(field: KPlanesField, t, warp_axis: int, d_idx: int, R_loc: int) -> torch.Tensor:
    """Rows [d_idx * R_loc, (d_idx + 1) * R_loc) along ``warp_axis`` of
    ``collapse_kplanes(field, t)``, in canonical [X, Y, Z, C] order: the
    planes that carry the warp axis are narrowed first, then the rank-k
    products accumulate in ascending k, as ``collapse_kplanes`` does."""
    v = _time_vectors(field.time, t)  # [3, R, K, C]: vx, vy, vz
    A = field.space[0] * v[0][:, None] * v[1][None, :]  # xy * vx * vy
    B = field.space[1] * v[2][None, :]  # xz * vz
    Cp = field.space[2]  # yz
    g0 = d_idx * R_loc
    if warp_axis == 0:  # x rows live in xy (dim 0) and xz (dim 0)
        A, B = A.narrow(0, g0, R_loc), B.narrow(0, g0, R_loc)
    elif warp_axis == 1:  # y rows live in xy (dim 1) and yz (dim 0)
        A, Cp = A.narrow(1, g0, R_loc), Cp.narrow(0, g0, R_loc)
    else:  # z rows live in xz (dim 1) and yz (dim 1)
        B, Cp = B.narrow(1, g0, R_loc), Cp.narrow(1, g0, R_loc)
    g = None
    for k in range(A.shape[2]):
        term = A[:, :, k][:, :, None] * B[:, :, k][:, None, :] * Cp[:, :, k][None]
        g = term if g is None else g + term
    return field.w * g + field.b


def make_kplanes_sp_step(
    mesh,
    *,
    resolution: int,
    warp_axis: int,
    flip: bool,
    bound: float = 1.0,
    sh_degree: int = 0,
    lr: float = 2e-2,
    tv_weight: float = 1e-4,
    time_smooth_weight: float = 1e-3,
    bg_color: float = 1.0,
    density_scale: float = 1.0,
    intermediate_scale: int = 2,
    remat: bool = True,
    block: int = 32,
):
    """Collapse-sharded K-planes step (intermediate-plane supervision).
    Returns (init, step): ``init(field)`` -> ``FieldState`` of the
    replicated planes; ``step(state, pose [4, 4], t, wgt [ri, ri, 3], mask
    [ri, ri])`` -> mse. As the VM step, there is no ``shard_fn``."""
    return _make_factor_sp_step(
        mesh, slab_fn=_collapse_local_slab, reg_fn=lambda f: kplanes_reg(f, tv_weight, time_smooth_weight),
        resolution=resolution, warp_axis=warp_axis, flip=flip, bound=bound, sh_degree=sh_degree, lr=lr,
        bg_color=bg_color, density_scale=density_scale, intermediate_scale=intermediate_scale, remat=remat,
        block=block, time_conditioned=True,
    )


def fit_kplanes_sp(
    poses: np.ndarray,  # [V, 4, 4] c2w
    images,  # [V, H, W, 3] in [0, 1]
    times: np.ndarray,  # [V] in [0, 1]
    intrinsics: Sequence[float],
    *,
    resolution: int = 128,
    rank: int = 8,
    time_res: int = 16,
    mesh=None,  # default: every rank on one "slice" axis
    bound: float = 1.0,
    sh_degree: int = 0,
    iters: int = 500,
    lr: float = 2e-2,
    tv_weight: float = 1e-4,
    time_smooth_weight: float = 1e-3,
    bg_color: float = 1.0,
    density_scale: float = 1.0,
    seed: int = 0,
    log_every: int = 0,
    intermediate_scale: int = 2,
    remat: bool = True,
    block: int = 32,
    group_chunk: int = 25,
    init_field: KPlanesField = None,
    device=None,
) -> Tuple[KPlanesField, Dict]:
    """Collapse-sharded K-planes fit (``main_voxel --voxel_sp --voxel_kplanes
    K``): the views grouped by (warp_axis, flip) variant and trained as
    ``fit_voxels_sp`` trains them, each step collapsing at its view's time.
    A fresh field draws from ``torch.Generator().manual_seed(seed)`` on
    every rank. Returns (field, info): "psnr", "rays_per_sec", "seconds",
    "n_devices", "step_mse"."""
    from focnerf_tpu_torch import resolve_device
    from focnerf_tpu_torch.parallel.mesh import make_mesh
    from focnerf_tpu_torch.train.voxel_kplanes import init_kplanes_field

    device = init_field.space.device if init_field is not None else resolve_device(device)
    if mesh is None:
        mesh = make_mesh(axis_names=("slice",), device=device)
    field = init_field
    if field is None:
        field = init_kplanes_field(resolution, rank=rank, time_res=time_res, sh_degree=sh_degree,
                                   generator=torch.Generator().manual_seed(seed), device=device)

    def make_step(key):
        return make_kplanes_sp_step(
            mesh, resolution=resolution, warp_axis=key[0], flip=key[1], bound=bound, sh_degree=sh_degree, lr=lr,
            tv_weight=tv_weight, time_smooth_weight=time_smooth_weight, bg_color=bg_color,
            density_scale=density_scale, intermediate_scale=intermediate_scale, remat=remat, block=block,
        )

    return _fit_replicated_sp_loop(
        poses, images, intrinsics, mesh=mesh, make_step=make_step, params=field,
        times=np.asarray(times, np.float32), bound=bound, iters=iters, seed=seed, log_every=log_every,
        ri=resolution * intermediate_scale, group_chunk=group_chunk, tag="spkplanes",
    )


def fit_kplanes_sp_c2f(
    poses: np.ndarray,
    images,
    times: np.ndarray,
    intrinsics: Sequence[float],
    *,
    resolution: int = 128,
    stages: int = 3,
    iters: int = 500,
    mesh=None,
    seed: int = 0,
    log_every: int = 0,
    rank: int = 8,
    time_res: int = 16,
    device=None,
    **kw,
) -> Tuple[KPlanesField, Dict]:
    """Coarse-to-fine collapse-sharded K-planes fit on the shared ladder
    (``train/voxel.py::_c2f_stage_plan``): the planes are replicated, so a
    stage only upsamples them (``upsample_kplanes``). Every ladder
    resolution must divide over the ranks."""
    from focnerf_tpu_torch.parallel.mesh import make_mesh
    from focnerf_tpu_torch.train.voxel import _c2f_stage_plan
    from focnerf_tpu_torch.train.voxel_kplanes import upsample_kplanes

    if mesh is None:
        mesh = make_mesh(axis_names=("slice",), device=device)
    D = mesh.size()
    plan = _c2f_stage_plan(resolution, stages, iters)
    for R, _ in plan:
        if R % D:
            raise ValueError(f"c2f ladder resolution {R} must divide the {D}-device mesh")
    field, info = None, {}
    stage_psnrs, step_mse = [], []
    for si, (R, n_it) in enumerate(plan):
        if field is not None:
            field = upsample_kplanes(field, R)
        field, info = fit_kplanes_sp(poses, images, times, intrinsics, resolution=R, mesh=mesh, iters=n_it,
                                     init_field=field, seed=seed + si, log_every=log_every, rank=rank,
                                     time_res=time_res, device=device, **kw)
        stage_psnrs.append(info["psnr"])
        step_mse.append(info["step_mse"])
    info["stage_psnrs"] = stage_psnrs
    info["step_mse"] = np.concatenate(step_mse)
    return field, info
