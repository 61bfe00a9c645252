"""Collapse-sharded slice parallelism for the VM-factorized voxel family.

Twin of focnerf_tpu/parallel/vm_sp.py. The VM family (``train/voxel_vm.py``)
collapses its planes x vectors into the dense [R, R, R, C] raw grid before
every fold; at 512^3 that grid and its autograd residuals, not the factors,
fill the device. Here each rank collapses only its own warp-axis slab of the
grid, straight from the (small, replicated) factors: the factor operands
that carry the warp axis are narrowed to the rank's rows before the three
einsums, so the einsums' output and every residual are cut 1/D. The slabs
fold and combine in optical-depth space exactly as the dense SP step's
(``parallel/voxel_sp.py::_sp_slab_strip_mse``, shared).

The factors and their Adam moments are replicated. Each rank's backward
gives its slab's share of the factor gradient (zero outside its rows for
the narrowed factors, a partial sum for the ones it reads whole), and one
all-reduce SUMs the shares: the transpose of JAX's replicated ``shard_map``
input. The regularizer (``vm_reg``) reads only the factors; JAX evaluates
it once, outside the ``shard_map``, so its gradient is added after the sum
(alike on every rank), never summed D times.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from focnerf_tpu_torch.parallel.voxel_sp import _fit_replicated_sp_loop, _make_factor_sp_step
from focnerf_tpu_torch.train.voxel_vm import VMField, vm_reg


def _collapse_vm_local_slab(field: VMField, warp_axis: int, d_idx: int, R_loc: int) -> torch.Tensor:
    """Rows [d_idx * R_loc, (d_idx + 1) * R_loc) along ``warp_axis`` of
    ``collapse_vm(field)``, in canonical [X, Y, Z, C] order:

        raw[x, y, z, c] = sum_k P0[y, z, k, c] V0[x, k, c] + P1[x, z, k, c] V1[y, k, c]
                        + P2[x, y, k, c] V2[z, k, c] + bias[c]

    The factors that carry the warp axis are narrowed first; ``narrow``'s
    backward pads the gradient with zeros to the full shape."""
    P0, P1, P2 = field.planes[0], field.planes[1], field.planes[2]
    V0, V1, V2 = field.vectors[0], field.vectors[1], field.vectors[2]
    g0 = d_idx * R_loc

    def rows(p, dim):
        return p.narrow(dim, g0, R_loc)

    if warp_axis == 0:  # x rows: V0 (dim 0), P1 and P2 carry x at dim 0
        V0, P1, P2 = rows(V0, 0), rows(P1, 0), rows(P2, 0)
    elif warp_axis == 1:  # y rows: P0 at dim 0, V1 dim 0, P2 at dim 1
        P0, V1, P2 = rows(P0, 0), rows(V1, 0), rows(P2, 1)
    else:  # z rows: P0 at dim 1, P1 at dim 1, V2 dim 0
        P0, P1, V2 = rows(P0, 1), rows(P1, 1), rows(V2, 0)
    g = torch.einsum("yzkc,xkc->xyzc", P0, V0)
    g = g + torch.einsum("xzkc,ykc->xyzc", P1, V1)
    g = g + torch.einsum("xykc,zkc->xyzc", P2, V2)
    return g + field.bias


def make_vm_sp_step(
    mesh,
    *,
    resolution: int,
    warp_axis: int,
    flip: bool,
    bound: float = 1.0,
    sh_degree: int = 0,
    lr: float = 2e-2,
    tv_weight: float = 1e-4,
    l1_weight: float = 0.0,
    bg_color: float = 1.0,
    density_scale: float = 1.0,
    intermediate_scale: int = 2,
    remat: bool = True,
    block: int = 32,
):
    """Collapse-sharded VM step (intermediate-plane supervision). Returns
    (init, step): ``init(field)`` -> ``FieldState`` of the replicated
    factors; ``step(state, pose [4, 4], wgt [ri, ri, 3], mask [ri, ri])`` ->
    mse. Nothing persistent is cut, so there is no ``shard_fn``: a variant
    switch changes only the step."""
    return _make_factor_sp_step(
        mesh, slab_fn=lambda f, t, ax, d, n: _collapse_vm_local_slab(f, ax, d, n),
        reg_fn=lambda f: vm_reg(f, tv_weight, l1_weight), resolution=resolution, warp_axis=warp_axis, flip=flip,
        bound=bound, sh_degree=sh_degree, lr=lr, bg_color=bg_color, density_scale=density_scale,
        intermediate_scale=intermediate_scale, remat=remat, block=block,
    )


def fit_vm_sp(
    poses: np.ndarray,  # [V, 4, 4] c2w
    images,  # [V, H, W, 3] in [0, 1]
    intrinsics: Sequence[float],
    *,
    resolution: int = 128,
    rank: int = 16,
    mesh=None,  # default: every rank on one "slice" axis
    bound: float = 1.0,
    sh_degree: int = 0,
    iters: int = 500,
    lr: float = 2e-2,
    tv_weight: float = 1e-4,
    l1_weight: float = 0.0,
    bg_color: float = 1.0,
    density_scale: float = 1.0,
    seed: int = 0,
    log_every: int = 0,
    intermediate_scale: int = 2,
    remat: bool = True,
    block: int = 32,
    group_chunk: int = 25,
    init_field: VMField = None,
    device=None,
):
    """Collapse-sharded VM fit: the views grouped by (warp_axis, flip)
    variant, iterations apportioned by group size and trained in chunks of
    ``group_chunk`` (JAX's draws from ``np.random.default_rng(seed)``). A
    fresh field draws from ``torch.Generator().manual_seed(seed)`` on every
    rank. Returns (volume, info); info["field"] holds the factors."""
    from focnerf_tpu_torch import resolve_device
    from focnerf_tpu_torch.parallel.mesh import make_mesh
    from focnerf_tpu_torch.train.voxel_vm import init_vm_field, vm_field_to_volume

    device = init_field.planes.device if init_field is not None else resolve_device(device)
    if mesh is None:
        mesh = make_mesh(axis_names=("slice",), device=device)
    field = init_field
    if field is None:
        field = init_vm_field(resolution, rank=rank, sh_degree=sh_degree,
                              generator=torch.Generator().manual_seed(seed), device=device)

    def make_step(key):
        return make_vm_sp_step(
            mesh, resolution=resolution, warp_axis=key[0], flip=key[1], bound=bound, sh_degree=sh_degree, lr=lr,
            tv_weight=tv_weight, l1_weight=l1_weight, bg_color=bg_color, density_scale=density_scale,
            intermediate_scale=intermediate_scale, remat=remat, block=block,
        )

    field, info = _fit_replicated_sp_loop(
        poses, images, intrinsics, mesh=mesh, make_step=make_step, params=field, times=None, bound=bound,
        iters=iters, seed=seed, log_every=log_every, ri=resolution * intermediate_scale, group_chunk=group_chunk,
        tag="vmsp",
    )
    info["field"] = field
    return vm_field_to_volume(field, bound, sh_degree), info
