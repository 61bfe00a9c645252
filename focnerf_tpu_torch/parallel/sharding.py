"""Data-parallel hash-grid train steps and object-sharded composition.

Twin of focnerf_tpu/parallel/sharding.py. JAX writes these as one global
program that XLA partitions; here every rank runs the port's own step on
its rows and the ranks meet in explicit collectives:

  - ``make_sharded_train_step`` / ``make_sharded_train_step_occupancy``:
    every rank passes the same GLOBAL batch and draws (as JAX's sharded
    step takes the global batch and key) and keeps its contiguous block of
    rays and of the per-ray draws (``bg``, ``noise``/``z_noise``/``pdf_u``
    and the corner uniforms ``u``; the TV points ``tv_x`` stay whole, as
    they are replicated in JAX). It computes the loss on its rows,
    averages the gradients over the ranks (one all-reduce) and applies the
    same Adam/EMA update, so every rank holds the same bits. The mask
    penalty is the norm of sigma outside the mask over the GLOBAL batch:
    the sum of squares is summed over the ranks before the root. On CUDA
    tensors each rank launches ``composite_rays_fused``, its backward and
    ``hashgrid_table_grad``;
  - ``shard_objects`` / ``compose_rays_sharded``: each rank folds its K/W
    objects by max density, the ranks fuse their folds (max of sigma, the
    mean rgb of the ranks that hold that max), and the composite forward
    kernel runs on the fused samples.
"""

from __future__ import annotations

from typing import Dict

import torch

from focnerf_tpu_torch.models.nerf import NeRFConfig
from focnerf_tpu_torch.parallel.collectives import all_max, all_mean, all_sum, gather, mean_gradients
from focnerf_tpu_torch.parallel.mesh import shard_batch
from focnerf_tpu_torch.train.state import TrainState, param_leaves
from focnerf_tpu_torch.train.steps import occupancy_loss, uniform_loss

PER_RAY_KEYS = ("rays_o", "rays_d", "pixels", "ray_mask", "inds_coarse")


def _local(batch: Dict, draws: Dict, mesh, axis: str):
    """This rank's rows of the per-ray batch entries and of every draw but
    the TV points; the rest (obj_feat, error_map, tv_x) stays whole."""
    n_rays = batch["rays_o"].shape[0]
    world = mesh.size(mesh.mesh_dim_names.index(axis))
    if n_rays % world:
        raise ValueError(f"{n_rays} rays do not divide over {world} ranks")
    per_ray = {k: v for k, v in batch.items() if k in PER_RAY_KEYS}
    rows = {k: v for k, v in draws.items() if k != "tv_x"}
    return ({**batch, **shard_batch(per_ray, mesh, axis)},
            {**draws, **shard_batch(rows, mesh, axis)})


def _global_norm(group, world: int):
    """The mask penalty's norm over every rank's rows: sqrt(sum over ranks of
    the sum of squares + 1e-12), JAX's ``_safe_norm`` of the global batch.
    Its gradient is scaled by the world size: the step averages gradients
    over the ranks, and each rank's gradient here is its own rows' share."""

    def norm(x):
        n = torch.sqrt(all_sum((x * x).sum(), group) + 1e-12)
        return n + (world - 1) * (n - n.detach())

    return norm


def _make_step(loss_fn, mesh, axis: str):
    """(step, group): step(state, batch, draws, *args) -> (global loss, this
    rank's aux) runs ``loss_fn`` on this rank's rows, averages the gradients
    over the ranks and applies them."""
    group = mesh.get_group(axis)
    norm_fn = _global_norm(group, mesh.size(mesh.mesh_dim_names.index(axis)))

    def step(state: TrainState, batch: Dict, draws: Dict, *args):
        lbatch, ldraws = _local(batch, draws, mesh, axis)
        loss, aux = loss_fn(state.params, lbatch, ldraws, *args, norm_fn=norm_fn)
        loss.backward()
        mean_gradients(param_leaves(state.params), group)
        state.apply_gradients()
        return all_mean(loss.detach(), group), aux

    return step, group


def make_sharded_train_step(cfg: NeRFConfig, mesh, *, axis: str = "data", **kw):
    """Data-parallel ``train_step``: step(state, batch, draws) -> metrics
    {"loss" (the global batch's), "per_ray_error" [N] (every rank's rows, in
    order)}; ``state`` is updated in place, alike on every rank. ``kw`` as
    ``uniform_loss`` (num_steps, mask_penalty, ...)."""

    def loss_fn(params, batch, draws, norm_fn):
        return uniform_loss(params, cfg, batch, draws, norm_fn=norm_fn, **kw)

    inner, group = _make_step(loss_fn, mesh, axis)

    def step(state: TrainState, batch: Dict, draws: Dict) -> Dict:
        loss, aux = inner(state, batch, draws)
        return {"loss": loss, "per_ray_error": gather(aux["per_ray_error"], group).reshape(-1)}

    return step


def make_sharded_train_step_occupancy(cfg: NeRFConfig, mesh, *, axis: str = "data", **kw):
    """Data-parallel ``train_step_occupancy``: step(state, batch, occ, draws)
    -> metrics {"loss", "per_ray_error" [N], "mean_samples", "march_iters"
    (the most any rank walked)}; ``occ`` (bitfield or skip field) is the
    same on every rank. ``kw`` as ``occupancy_loss``."""

    def loss_fn(params, batch, draws, occ, norm_fn):
        return occupancy_loss(params, cfg, batch, occ, draws, norm_fn=norm_fn, **kw)

    inner, group = _make_step(loss_fn, mesh, axis)

    def step(state: TrainState, batch: Dict, occ: torch.Tensor, draws: Dict) -> Dict:
        loss, aux = inner(state, batch, draws, occ)
        iters = torch.tensor(float(aux["march_iters"]), device=loss.device)
        return {
            "loss": loss,
            "per_ray_error": gather(aux["per_ray_error"], group).reshape(-1),
            "mean_samples": all_mean(aux["n_samples"].float().mean(), group),
            "march_iters": int(all_max(iters, group)),
        }

    return step


def shard_objects(stacked_params, mesh, axis: str = "data"):
    """This rank's contiguous block of the K objects (``stack_object_params``'
    list); K must divide over the mesh axis."""
    i, n = mesh.get_local_rank(axis), mesh.size(mesh.mesh_dim_names.index(axis))
    K = len(stacked_params)
    if K % n:
        raise ValueError(f"{K} objects do not divide over {n} ranks")
    per = K // n
    return list(stacked_params)[i * per:(i + 1) * per]


@torch.no_grad()
def compose_rays_sharded(
    local_params,
    cfg: NeRFConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    mesh,
    obj_feats=None,  # [K, F] every object's (this rank's rows are used)
    offsets=None,  # [K, 3]
    *,
    axis: str = "data",
    num_steps: int = 512,
    bg_color=1.0,
    min_near: float = 0.2,
) -> Dict[str, torch.Tensor]:
    """Object-parallel composition of one ray chunk (rays on every rank):
    ``local_params`` are this rank's objects (``shard_objects``). Returns
    dict(image [N, 3], depth [N], alpha [N]), alike on every rank."""
    from focnerf_tpu_torch.core.geometry import near_far_from_aabb
    from focnerf_tpu_torch.ops.composite import composite_rays_fused
    from focnerf_tpu_torch.render.compose import _fold_objects
    from focnerf_tpu_torch.render.renderer import _aabb

    group = mesh.get_group(axis)
    k_loc = len(local_params)
    i = mesh.get_local_rank(axis)
    rows = slice(i * k_loc, (i + 1) * k_loc)
    if obj_feats is not None:
        obj_feats = torch.as_tensor(obj_feats, dtype=torch.float32, device=rays_o.device)[rows]
    if offsets is not None:
        offsets = torch.as_tensor(offsets, dtype=torch.float32, device=rays_o.device)[rows]
    aabb = _aabb(cfg, None, rays_o.device)
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, min_near)
    z = torch.linspace(0.0, 1.0, num_steps, dtype=torch.float32, device=rays_o.device)[None, :]
    z_vals = nears[:, None] + (fars - nears)[:, None] * z
    sample_dist = (fars - nears)[:, None] / num_steps
    deltas = torch.cat([z_vals[..., 1:] - z_vals[..., :-1], sample_dist], dim=-1)
    sigma, rgb = _fold_objects(local_params, cfg, rays_o, rays_d, z_vals, aabb, obj_feats, offsets, None)

    # cross-rank max-density fusion (JAX's pmax + masked psum)
    g_sigma = all_max(sigma, group)
    mask = (sigma == g_sigma) & (g_sigma > 0)
    rgb_sum = all_sum(torch.where(mask[..., None], rgb, torch.zeros_like(rgb)), group)
    count = all_sum(mask.float(), group)
    fused_rgb = rgb_sum / torch.clamp(count, min=1.0)[..., None]

    ori_z = torch.clamp((z_vals - nears[:, None]) / torch.clamp(fars - nears, min=1e-10)[:, None], 0.0, 1.0)
    image, weights_sum, depth = composite_rays_fused(
        g_sigma, fused_rgb.contiguous(), deltas.contiguous(), ori_z.contiguous(), bg_color=bg_color,
        density_scale=cfg.density_scale, T_thresh=0.0,
    )
    return {"image": image, "depth": depth, "alpha": weights_sum}
