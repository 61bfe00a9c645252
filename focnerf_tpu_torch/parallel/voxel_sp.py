"""Slice-parallel training of the dense voxel family (SP, and DP x SP).

Twin of focnerf_tpu/parallel/voxel_sp.py. The raw field is cut along the
shear-warp slice axis into one slab per rank; alpha compositing is
associative, so each rank folds only its own slices (``render/baked.py::
_fold_blocks`` from the identity carry) and the ranks' partial images
combine in optical-depth space:

    T = prod_d T_d,   C = sum_d (prod_{d' in front of d} T_d') * C_d

The field, its gradient and the Adam moments stay cut for the whole run.
Per step the ranks exchange the [D, ri, ri, C+1] partials (a
differentiable all-gather), every rank's first slice (the TV term's halo
on the cut axis; gloo sends no CUDA tensor point to point, so this too is
an all-gather, R x R x C) and two scalar sums. The photometric loss is the
sum of per-rank row strips of the composed image: each rank differentiates
only its strip, and the gather's backward (``parallel/collectives.py``)
sums the strips' cotangents into each rank's slab, as ``shard_map``'s
transpose does in JAX.

One step serves one (warp_axis, flip) variant: the cut axis must be the
warp axis. ``fit_voxels_sp`` groups the views by variant and trains them in
round-robin chunks; when the warp axis changes it gathers the field and its
Adam moments and cuts them along the new axis.

On the card the fold resamples bf16 operands (as ``_composite_core``
does), so SP and the single-device step agree closely there but not to the
bit; on the CPU (fp32) they agree to the rounding of the partial combine.
"""

from __future__ import annotations

import time
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from focnerf_tpu_torch.interop import field_slab, join_field_slabs
from focnerf_tpu_torch.parallel.collectives import all_mean, all_sum, gather, mean_gradients, sum_gradients
from focnerf_tpu_torch.parallel.distributed import is_main_process
from focnerf_tpu_torch.train.voxel import FieldState


def _apportion_views(poses, bound, iters):
    """Group views by (warp_axis, flip) variant and split ``iters`` over the
    groups in proportion to their view counts, largest remainder first, so
    the counts sum to exactly ``iters``. Returns (groups {key: [view]},
    sorted keys, remaining {key: n})."""
    from focnerf_tpu_torch.train.voxel import _pose_variant

    groups = {}
    for v in range(len(poses)):
        groups.setdefault(_pose_variant(poses[v], bound), []).append(v)
    keys = sorted(groups)
    sizes = np.array([len(groups[k]) for k in keys], np.float64)
    quota = sizes / sizes.sum() * iters
    base = np.floor(quota).astype(int)
    for i in np.argsort(-(quota - base))[: iters - int(base.sum())]:
        base[i] += 1
    return groups, keys, dict(zip(keys, base.tolist()))


def _sp_slab_strip_mse(
    raw_loc,
    pose,
    wgt,
    mask,
    d_idx: int,
    *,
    group,
    warp_axis: int,
    flip: bool,
    R: int,
    R_loc: int,
    ri: int,
    rows_loc: int,
    bound: float,
    sh_degree: int,
    density_scale: float,
    bg_color: float,
    remat: bool,
    block: int,
):
    """Activate this rank's raw slab, fold it front to back, combine every
    rank's partial in optical-depth space, and return the masked mse of the
    composed intermediate image, as the sum of the ranks' row strips."""
    from focnerf_tpu_torch.render.baked import (
        _cell_centers,
        _device_dtype,
        _fold_blocks,
        _grid_geometry,
        sh_contract_plane,
    )

    b = float(bound)
    others = [a for a in range(3) if a != warp_axis]
    payload = raw_loc[..., :-1] if sh_degree > 0 else torch.sigmoid(raw_loc[..., :-1])
    V = torch.cat([payload, F.softplus(raw_loc[..., -1:])], -1)
    CH = V.shape[-1]
    V = V.permute(warp_axis, others[0], others[1], 3)  # the cut (warp) axis leads
    dtype = _device_dtype(V)
    if dtype != V.dtype:
        V = V.to(dtype)

    e = pose[:3, 3]
    e_z, e_y, e_x = e[warp_axis], e[others[0]], e[others[1]]
    c_loc = _cell_centers(R, b, raw_loc.device)[d_idx * R_loc:(d_idx + 1) * R_loc]
    if flip:  # mirror trick: ascending storage order is front to back
        e_z = -e_z
        V_f2b, z_f2b = V, -c_loc
    else:
        V_f2b, z_f2b = torch.flip(V, (0,)), torch.flip(c_loc, (0,))

    gy, gx, *_ = _grid_geometry(e_z, e_y, e_x, b, ri)
    dlen = torch.sqrt((gy[:, None] - e_y) ** 2 + (gx[None, :] - e_x) ** 2 + e_z**2)
    dt = (2.0 * b / R) * dlen / torch.clamp(e_z.abs(), min=1e-6)

    K = min(block, R_loc)
    if R_loc % K:
        raise ValueError(f"slab depth {R_loc} is not a multiple of the block {K}")
    od_d, C_d, _ = _fold_blocks(
        V_f2b.contiguous().view(R_loc // K, K, R, R, CH), z_f2b.reshape(R_loc // K, K),
        e_z, e_y, e_x, gy, gx, dt, b, R, ri,
        density_scale=density_scale, remat=remat, with_depth=False, return_od=True,
    )

    # combine the partials front to back (ascending rank with flip, else
    # descending) in optical-depth space: an opaque slab's T underflows to
    # 0 and a product form would divide by it in the backward. The
    # exclusive prefix is a shifted cumsum, never cum - own (inf - inf).
    parts = gather(torch.cat([C_d, od_d[..., None]], -1), group)  # [D, ri, ri, CH]
    if not flip:
        parts = torch.flip(parts, (0,))
    Cs, ods = parts[..., :-1], parts[..., -1]
    od_excl = torch.cat([torch.zeros_like(ods[:1]), torch.cumsum(ods[:-1], 0)], 0)
    C = torch.einsum("dij,dijc->ijc", torch.exp(-od_excl), Cs)
    T = torch.exp(-(od_excl[-1] + ods[-1]))
    if sh_degree > 0:  # one basis per intermediate pixel, after the combine
        C = sh_contract_plane(C, e_z, e_y, e_x, gy, gx, axis=warp_axis, flip=flip, ri=ri, sh_deg=sh_degree)
    img_i = C + T[..., None] * bg_color

    rows = slice(d_idx * rows_loc, (d_idx + 1) * rows_loc)
    m_s = mask[rows][..., None]
    sse = all_sum(torch.sum(m_s * (img_i[rows] - wgt[rows]) ** 2), group)
    msum = all_sum(torch.sum(m_s), group)
    return sse / (3.0 * torch.clamp(msum, min=1.0))


def _sp_tv_halo(raw_loc, d_idx: int, *, group, warp_axis: int, R: int, R_loc: int, D: int):
    """``tv_loss`` of the cut field (per-axis mean of squared differences,
    summed over the axes): on the cut axis each rank also takes the
    difference between the next rank's first slice and its own last."""
    tv = 0.0
    count = R * R * (R - 1) * raw_loc.shape[-1]  # differences per axis
    for ax in range(3):
        d = torch.diff(raw_loc, dim=ax)
        sse = torch.sum(d * d)
        if ax == warp_axis:
            firsts = gather(raw_loc.narrow(warp_axis, 0, 1), group)
            bd = firsts[(d_idx + 1) % D] - raw_loc.narrow(warp_axis, R_loc - 1, 1)
            # the last rank keeps the term at weight 0: every rank must run
            # the gather's backward
            sse = sse + float(d_idx < D - 1) * torch.sum(bd * bd)
        tv = tv + all_sum(sse, group) / count
    return tv


def _gather_field(slab: torch.Tensor, axis: int, group) -> torch.Tensor:
    """The full field from every rank's slab (cut along ``axis``)."""
    with torch.no_grad():
        return join_field_slabs(gather(slab.detach(), group), axis)


def _reshard(state: FieldState, old_axis: int, new_axis: int, group, index: int, count: int) -> None:
    """Re-cut the field and its Adam moments from ``old_axis`` to ``new_axis``
    in place (the step count is kept)."""
    p = state.leaves[0]
    p.grad = None
    recut = lambda t: field_slab(_gather_field(t, old_axis, group), new_axis, index, count)  # noqa: E731
    with torch.no_grad():
        p.data = recut(p)
        st = state.optimizer.state.get(p)
        if st:
            st["exp_avg"] = recut(st["exp_avg"])
            st["exp_avg_sq"] = recut(st["exp_avg_sq"])


def _sp_geometry(resolution: int, slices: int, intermediate_scale: int):
    R = resolution
    ri = R * intermediate_scale
    if R % slices or ri % slices:
        raise ValueError(f"resolution {R} (intermediate {ri}) must divide over {slices} slice shards")
    return R, R // slices, ri, ri // slices


def make_voxel_sp_step(
    mesh,
    intrinsics: Sequence[float],  # unused (intermediate supervision); kept for the DP step's signature
    *,
    resolution: int,
    warp_axis: int,
    flip: bool,
    bound: float = 1.0,
    sh_degree: int = 0,
    lr: float = 5e-2,
    tv_weight: float = 1e-4,
    bg_color: float = 1.0,
    density_scale: float = 1.0,
    intermediate_scale: int = 2,
    remat: bool = True,
    block: int = 32,
):
    """Slice-parallel dense step over a 1-D mesh (intermediate-plane
    supervision). Returns (init, step, shard_fn):
      - ``shard_fn(raw [R, R, R, C])`` -> this rank's slab along warp_axis;
      - ``init(slab)`` -> ``FieldState`` (the slab and its Adam);
      - ``step(state, pose [4, 4], wgt [ri, ri, 3], mask [ri, ri])`` -> mse
        (a device scalar, alike on every rank); every rank passes the same
        view. With ``sh_degree`` > 0 the SH payload is composited cut and
        contracted with the per-pixel basis after the combine."""
    del intrinsics
    axis = mesh.mesh_dim_names[0]
    group = mesh.get_group(axis)
    D, d_idx = mesh.size(0), mesh.get_local_rank(axis)
    R, R_loc, ri, rows_loc = _sp_geometry(resolution, D, intermediate_scale)

    def shard_fn(raw):
        return field_slab(raw, warp_axis, d_idx, D)

    def init(slab) -> FieldState:
        return FieldState(slab, lr)

    def step(state: FieldState, pose, wgt, mask):
        raw_loc = state.leaves[0]
        pose = torch.as_tensor(pose, dtype=torch.float32, device=raw_loc.device)
        state.optimizer.zero_grad(set_to_none=True)
        mse = _sp_slab_strip_mse(
            raw_loc, pose, wgt, mask, d_idx, group=group, warp_axis=warp_axis, flip=flip, R=R, R_loc=R_loc,
            ri=ri, rows_loc=rows_loc, bound=bound, sh_degree=sh_degree, density_scale=density_scale,
            bg_color=bg_color, remat=remat, block=block,
        )
        tv = _sp_tv_halo(raw_loc, d_idx, group=group, warp_axis=warp_axis, R=R, R_loc=R_loc, D=D)
        (mse + tv_weight * tv).backward()
        state.optimizer.step()
        return mse.detach()

    return init, step, shard_fn


def make_voxel_dp_sp_step(
    mesh,  # 2-D, dims ("data", "slice")
    *,
    resolution: int,
    warp_axis: int,
    flip: bool,
    bound: float = 1.0,
    sh_degree: int = 0,
    lr: float = 5e-2,
    tv_weight: float = 1e-4,
    bg_color: float = 1.0,
    density_scale: float = 1.0,
    intermediate_scale: int = 2,
    remat: bool = True,
    block: int = 32,
):
    """Hybrid pose-parallel x slice-parallel dense step: along "slice" the
    field, its gradient and Adam are cut as in ``make_voxel_sp_step``; along
    "data" each row of ranks trains another view of the batch and the slab
    gradients are averaged over the rows. Returns (init, step, shard_fn)
    with ``step(state, poses [Dd, 4, 4], wgts [Dd][ri, ri, 3], masks [Dd][ri,
    ri])`` -> the mean mse over the Dd views (every rank passes the whole
    batch and trains row ``data``'s view)."""
    if tuple(mesh.mesh_dim_names) != ("data", "slice"):
        raise ValueError(f"the hybrid step needs a ('data', 'slice') mesh, not {mesh.mesh_dim_names}")
    data_group, slice_group = mesh.get_group("data"), mesh.get_group("slice")
    row, Ds, d_idx = mesh.get_local_rank("data"), mesh.size(1), mesh.get_local_rank("slice")
    R, R_loc, ri, rows_loc = _sp_geometry(resolution, Ds, intermediate_scale)

    def shard_fn(raw):
        return field_slab(raw, warp_axis, d_idx, Ds)

    def init(slab) -> FieldState:
        return FieldState(slab, lr)

    def step(state: FieldState, poses, wgts, masks):
        raw_loc = state.leaves[0]
        pose = torch.as_tensor(poses[row], dtype=torch.float32, device=raw_loc.device)
        state.optimizer.zero_grad(set_to_none=True)
        mse = _sp_slab_strip_mse(
            raw_loc, pose, wgts[row], masks[row], d_idx, group=slice_group, warp_axis=warp_axis, flip=flip,
            R=R, R_loc=R_loc, ri=ri, rows_loc=rows_loc, bound=bound, sh_degree=sh_degree,
            density_scale=density_scale, bg_color=bg_color, remat=remat, block=block,
        )
        tv = _sp_tv_halo(raw_loc, d_idx, group=slice_group, warp_axis=warp_axis, R=R, R_loc=R_loc, D=Ds)
        (mse + tv_weight * tv).backward()
        mean_gradients(state.leaves, data_group)
        state.optimizer.step()
        return all_mean(mse.detach(), data_group)

    return init, step, shard_fn


def _sp_schedule(poses, bound: float, iters: int, seed: int, group_chunk: int, views_per_step: int = 1):
    """The SP fits' step order: (key, [view]) per step, the views of one
    (warp_axis, flip) group trained in round-robin chunks of ``group_chunk``
    and drawn as JAX draws them from ``np.random.default_rng(seed)``."""
    groups, keys, remaining = _apportion_views(poses, bound, iters)
    rng = np.random.default_rng(seed)
    while any(n > 0 for n in remaining.values()):
        for key in keys:
            take = min(group_chunk, remaining[key])
            if take == 0:
                continue
            remaining[key] -= take
            if views_per_step == 1:  # JAX draws a chunk's views at once, the hybrid's per step
                batches = [[int(v)] for v in rng.choice(groups[key], size=take)]
            else:  # ceil: iters count view updates
                batches = ([int(v) for v in rng.choice(groups[key], size=views_per_step)]
                           for _ in range(-(-take // views_per_step)))
            for views in batches:
                yield key, views


def _warp_targets(images, poses, intrinsics, bound: float, ri: int, device):
    """``targets_for(v, key)``: view v's GT pre-warped to the intermediate
    plane of variant ``key`` (wgt [ri, ri, 3], mask [ri, ri]), once a view."""
    from focnerf_tpu_torch.render.baked import warp_gt_to_intermediate

    gts = torch.as_tensor(images, dtype=torch.float32).to(device)
    intr = torch.as_tensor(np.asarray(intrinsics, np.float32), device=device)
    warped: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}

    def targets_for(v: int, key):
        if v not in warped:
            warped[v] = warp_gt_to_intermediate(gts[v], poses[v], intr, bound, axis=key[0], flip=key[1], ri=ri)
        return warped[v]

    return targets_for


def _make_factor_sp_step(mesh, *, slab_fn, reg_fn, resolution: int, warp_axis: int, flip: bool, bound: float,
                        sh_degree: int, lr: float, bg_color: float, density_scale: float, intermediate_scale: int,
                        remat: bool, block: int, time_conditioned: bool = False):
    """The collapse-sharded step of a factorized family (VM, K-planes) over a
    1-D mesh, the factors replicated:
    ``slab_fn(params, t, warp_axis, d_idx, R_loc)`` -> this rank's raw slab,
    ``reg_fn(params)`` -> the family regularizer. Returns (init, step):
    ``init(params)`` -> ``FieldState`` over the replicated factors;
    ``step(state, pose[, t], wgt, mask)`` -> the mse (alike on every rank)."""
    axis = mesh.mesh_dim_names[0]
    group = mesh.get_group(axis)
    D, d_idx = mesh.size(0), mesh.get_local_rank(axis)
    R, R_loc, ri, rows_loc = _sp_geometry(resolution, D, intermediate_scale)

    def init(params) -> FieldState:
        return FieldState(params, lr)

    def step(state: FieldState, pose, t, wgt, mask):
        params = state.params
        pose = torch.as_tensor(pose, dtype=torch.float32, device=state.leaves[0].device)
        state.optimizer.zero_grad(set_to_none=True)
        raw_loc = slab_fn(params, t, warp_axis, d_idx, R_loc)
        mse = _sp_slab_strip_mse(
            raw_loc, pose, wgt, mask, d_idx, group=group, warp_axis=warp_axis, flip=flip, R=R, R_loc=R_loc,
            ri=ri, rows_loc=rows_loc, bound=bound, sh_degree=sh_degree, density_scale=density_scale,
            bg_color=bg_color, remat=remat, block=block,
        )
        mse.backward()
        sum_gradients(state.leaves, group)
        reg_fn(params).backward()  # once, after the sum: JAX evaluates it outside the shard_map
        state.optimizer.step()
        return mse.detach()

    if time_conditioned:
        return init, step
    return init, lambda state, pose, wgt, mask: step(state, pose, None, wgt, mask)


def _fit_sp_loop(poses, images, intrinsics, *, mesh, make_step, views_per_step: int, resolution: int,
                 bound: float, sh_degree: int, iters: int, seed: int, log_every: int, intermediate_scale: int,
                 group_chunk: int, init_raw, device, tag: str):
    """The variant-grouped engine of ``fit_voxels_sp`` and ``fit_voxels_dp_sp``:
    ``make_step(key)`` -> (init, step, shard_fn) of one (axis, flip)
    variant; a step trains ``views_per_step`` views (drawn as JAX draws
    them). Returns (full raw field on every rank, info)."""
    from focnerf_tpu_torch import resolve_device
    from focnerf_tpu_torch.train.voxel import init_voxel_field

    device = init_raw.device if init_raw is not None else resolve_device(device)
    slice_axis = mesh.mesh_dim_names[-1]
    group = mesh.get_group(slice_axis)
    d_idx, Ds = mesh.get_local_rank(slice_axis), mesh.size(len(mesh.mesh_dim_names) - 1)
    poses = np.asarray(poses, np.float32)
    poses_dev = torch.as_tensor(poses, device=device)
    ri = resolution * intermediate_scale
    targets_for = _warp_targets(images, poses, intrinsics, bound, ri, device)
    steps: Dict[Tuple[int, bool], tuple] = {}

    raw = init_raw
    if raw is None:
        raw = init_voxel_field(resolution, sh_degree, generator=torch.Generator().manual_seed(seed), device=device)
    state, cur_axis, mses, done = None, None, [], 0
    t0 = time.time()
    for key, views in _sp_schedule(poses, bound, iters, seed, group_chunk, views_per_step):
        if key not in steps:
            steps[key] = make_step(key)
        init, step, shard_fn = steps[key]
        if state is None:
            state = init(shard_fn(raw))
        elif key[0] != cur_axis:  # flip shares the axis: no re-cut
            _reshard(state, cur_axis, key[0], group, d_idx, Ds)
        cur_axis = key[0]
        tw = [targets_for(v, key) for v in views]
        if views_per_step == 1:
            mse = step(state, poses_dev[views[0]], *tw[0])
        else:
            mse = step(state, poses[views], [t[0] for t in tw], [t[1] for t in tw])
        mses.append(mse)
        done += views_per_step
        n_steps = done // views_per_step
        if log_every and n_steps % log_every == 0 and is_main_process():
            print(f"[{tag}] view-updates {done}/{iters} mse {float(mse):.5f}" if views_per_step > 1
                  else f"[{tag}] iter {done}/{iters} mse {float(mse):.5f}", flush=True)
    step_mse = torch.stack(mses).cpu().numpy()
    dt = time.time() - t0
    raw = _gather_field(state.leaves[0], cur_axis, group)
    info = {
        "psnr": -10.0 * float(np.log10(max(float(step_mse[-1]), 1e-10))),
        "rays_per_sec": ri * ri * done / dt,
        "seconds": dt,
        "raw": raw,
        "n_devices": mesh.size(),
        "step_mse": step_mse,
    }
    return raw, info


def _fit_replicated_sp_loop(poses, images, intrinsics, *, mesh, make_step, params, times, bound: float,
                            iters: int, seed: int, log_every: int, ri: int, group_chunk: int, tag: str):
    """The variant-grouped engine of the collapse-sharded factor fits
    (``parallel/vm_sp.py``, ``kplanes_sp.py``): the factors and their Adam
    are replicated, so a variant switch changes only the step, never the
    state. ``make_step(key)`` -> (init, step); ``times`` None, or [V] (the
    step then takes each view's time). Returns (the trained factors, info)."""
    device = params[0].device
    poses = np.asarray(poses, np.float32)
    poses_dev = torch.as_tensor(poses, device=device)
    targets_for = _warp_targets(images, poses, intrinsics, bound, ri, device)
    steps: Dict[Tuple[int, bool], tuple] = {}
    state, mses = None, []
    t0 = time.time()
    for key, (v,) in _sp_schedule(poses, bound, iters, seed, group_chunk):
        if key not in steps:
            steps[key] = make_step(key)
        init, step = steps[key]
        if state is None:
            state = init(params)
        t = () if times is None else (float(times[v]),)
        mse = step(state, poses_dev[v], *t, *targets_for(v, key))
        mses.append(mse)
        if log_every and len(mses) % log_every == 0 and is_main_process():
            print(f"[{tag}] iter {len(mses)}/{iters} mse {float(mse):.5f}", flush=True)
    step_mse = torch.stack(mses).cpu().numpy()
    dt = time.time() - t0
    info = {
        "psnr": -10.0 * float(np.log10(max(float(step_mse[-1]), 1e-10))),
        "rays_per_sec": ri * ri * len(mses) / dt,
        "seconds": dt,
        "n_devices": mesh.size(),
        "step_mse": step_mse,
    }
    return state.detached(), info


def fit_voxels_sp(
    poses: np.ndarray,  # [V, 4, 4] c2w
    images,  # [V, H, W, 3] in [0, 1]
    intrinsics: Sequence[float],
    *,
    resolution: int = 128,
    mesh=None,  # default: every rank on one "slice" axis
    bound: float = 1.0,
    sh_degree: int = 0,
    iters: int = 500,
    lr: float = 5e-2,
    tv_weight: float = 1e-4,
    bg_color: float = 1.0,
    density_scale: float = 1.0,
    seed: int = 0,
    log_every: int = 0,
    intermediate_scale: int = 2,
    remat: bool = True,
    block: int = 32,
    group_chunk: int = 25,
    init_raw=None,  # full [R, R, R, C] seed (coarse-to-fine staging)
    device=None,
):
    """Slice-parallel dense fit (``main_voxel --voxel_sp``): the views are
    grouped by (warp_axis, flip) variant, iterations apportioned by group
    size, and each group trained in chunks of ``group_chunk`` (JAX's view
    draws from ``np.random.default_rng(seed)``). A fresh field draws its
    colour noise from ``torch.Generator().manual_seed(seed)`` on every
    rank. Returns (volume, info) like ``fit_voxels``; info["raw"] is the
    full field (gathered on every rank), info["n_devices"] the ranks."""
    from focnerf_tpu_torch.parallel.mesh import make_mesh
    from focnerf_tpu_torch.train.voxel import field_to_volume

    if mesh is None:
        mesh = make_mesh(axis_names=("slice",), device=init_raw.device if init_raw is not None else device)

    def make_step(key):
        return make_voxel_sp_step(
            mesh, intrinsics, resolution=resolution, warp_axis=key[0], flip=key[1], bound=bound,
            sh_degree=sh_degree, lr=lr, tv_weight=tv_weight, bg_color=bg_color, density_scale=density_scale,
            intermediate_scale=intermediate_scale, remat=remat, block=block,
        )

    raw, info = _fit_sp_loop(
        poses, images, intrinsics, mesh=mesh, make_step=make_step, views_per_step=1, resolution=resolution,
        bound=bound, sh_degree=sh_degree, iters=iters, seed=seed, log_every=log_every,
        intermediate_scale=intermediate_scale, group_chunk=group_chunk, init_raw=init_raw, device=device,
        tag="spvoxel",
    )
    return field_to_volume(raw, bound, sh_degree), info


def fit_voxels_sp_c2f(
    poses: np.ndarray,
    images,
    intrinsics: Sequence[float],
    *,
    resolution: int = 128,
    stages: int = 3,
    iters: int = 500,
    mesh=None,
    seed: int = 0,
    log_every: int = 0,
    device=None,
    **kw,
):
    """Coarse-to-fine slice-parallel fit on ``_c2f_stage_plan``'s ladder:
    between stages the full field is upsampled (alike on every rank) and
    cut again. Every ladder resolution must divide over the slice shards."""
    from focnerf_tpu_torch.parallel.mesh import make_mesh
    from focnerf_tpu_torch.train.voxel import _c2f_stage_plan, upsample_field

    if mesh is None:
        mesh = make_mesh(axis_names=("slice",), device=device)
    D = mesh.size()
    plan = _c2f_stage_plan(resolution, stages, iters)
    for R, _ in plan:
        if R % D:
            raise ValueError(f"c2f ladder resolution {R} must divide over the {D} slice shards")
    raw, vol, info = None, None, {}
    stage_psnrs, step_mse = [], []
    for si, (R, n_it) in enumerate(plan):
        if raw is not None:
            raw = upsample_field(raw, R)
        vol, info = fit_voxels_sp(poses, images, intrinsics, resolution=R, mesh=mesh, iters=n_it, init_raw=raw,
                                  seed=seed + si, log_every=log_every, device=device, **kw)
        stage_psnrs.append(info["psnr"])
        step_mse.append(info["step_mse"])
        raw = info["raw"]
    info["stage_psnrs"] = stage_psnrs
    info["step_mse"] = np.concatenate(step_mse)
    return vol, info


def fit_voxels_dp_sp(
    poses: np.ndarray,
    images,
    intrinsics: Sequence[float],
    *,
    resolution: int = 128,
    mesh=None,  # 2-D ("data", "slice"); default (dp, world // dp)
    dp: int = 2,
    bound: float = 1.0,
    sh_degree: int = 0,
    iters: int = 500,
    lr: float = 5e-2,
    tv_weight: float = 1e-4,
    bg_color: float = 1.0,
    density_scale: float = 1.0,
    seed: int = 0,
    log_every: int = 0,
    intermediate_scale: int = 2,
    remat: bool = True,
    block: int = 32,
    group_chunk: int = 25,
    init_raw=None,
    device=None,
):
    """Hybrid DP x SP dense fit (``main_voxel --voxel_sp --voxel_dp N``): each
    step trains ``dp`` views of one variant group at once; ``iters`` counts
    view updates. Returns (volume, info) like ``fit_voxels_sp``, with
    info["mesh"] = {"data": dp, "slice": world // dp}."""
    from focnerf_tpu_torch.parallel.distributed import initialize
    from focnerf_tpu_torch.parallel.mesh import make_mesh
    from focnerf_tpu_torch.train.voxel import field_to_volume

    if mesh is None:
        world = initialize(device=device)["num_processes"]
        if world % dp:
            raise ValueError(f"--voxel_dp {dp} must divide the {world} ranks")
        mesh = make_mesh((dp, world // dp), ("data", "slice"), device=device)

    def make_step(key):
        return make_voxel_dp_sp_step(
            mesh, resolution=resolution, warp_axis=key[0], flip=key[1], bound=bound, sh_degree=sh_degree, lr=lr,
            tv_weight=tv_weight, bg_color=bg_color, density_scale=density_scale,
            intermediate_scale=intermediate_scale, remat=remat, block=block,
        )

    raw, info = _fit_sp_loop(
        poses, images, intrinsics, mesh=mesh, make_step=make_step, views_per_step=mesh.size(0),
        resolution=resolution, bound=bound, sh_degree=sh_degree, iters=iters, seed=seed, log_every=log_every,
        intermediate_scale=intermediate_scale, group_chunk=group_chunk, init_raw=init_raw, device=device,
        tag="dpspvoxel",
    )
    info["mesh"] = {"data": mesh.size(0), "slice": mesh.size(1)}
    return field_to_volume(raw, bound, sh_degree), info
