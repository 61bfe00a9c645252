"""The D-NeRF train steps: uniform samples, and the time slot's occupancy march.

Twin of focnerf_tpu/train/dnerf_steps.py (dnerf/utils.py train_step): the
batch's per-frame ``time`` threads through the render; RGBA ground truth is
composited onto a per-pixel random background; loss = per-ray mean-channel
MSE + ``DEFORM_REG`` * mean |dx| (the deform variant's L1 term,
dnerf/utils.py:117-119); one autograd backward (the table's gradient
through the scatter kernel on the card, the deformation's and the hyper
coordinates' through the encode's position gradient, the composite's
through its backward kernel), then ``TrainState.apply_gradients`` (Adam
with eps 1e-15, the LR schedule, the EMA).

torch cannot reproduce the JAX PRNG, so a step takes its draws as tensors;
``dnerf_step_draws`` makes them from a ``torch.Generator`` in the JAX
step's shapes: ``bg`` [N, 3] and either the march jitter ``noise`` [N]
(occupancy) or the sample jitter ``z_noise`` [N, num_steps] (uniform). The
encode is exact, so there are no corner draws.
"""

from __future__ import annotations

from typing import Dict

import torch

from focnerf_tpu_torch.models.dnerf import DNeRFConfig
from focnerf_tpu_torch.render.dnerf_renderer import render_rays_dnerf, render_rays_dnerf_occupancy
from focnerf_tpu_torch.train.state import TrainState

DEFORM_REG = 1e-3  # dnerf/utils.py:117-119


def dnerf_step_draws(generator: torch.Generator, n_rays: int, device, *, num_steps: int = 0) -> Dict:
    """The draws of one D-NeRF step: ``bg`` [N, 3], then ``z_noise`` [N,
    num_steps] when ``num_steps`` > 0 (uniform), else ``noise`` [N] (occupancy)."""
    kw = dict(generator=generator, device=device)
    draws = {"bg": torch.rand((n_rays, 3), **kw)}
    if num_steps > 0:
        draws["z_noise"] = torch.rand((n_rays, num_steps), **kw)
    else:
        draws["noise"] = torch.rand((n_rays,), **kw)
    return draws


def _gt_and_bg(pixels: torch.Tensor, bg: torch.Tensor):
    """(RGB target, background): RGBA composited onto the random ``bg``
    [N, 3]; an RGB batch has background 1."""
    if pixels.shape[-1] == 4:
        return pixels[..., :3] * pixels[..., 3:] + bg * (1.0 - pixels[..., 3:]), bg
    return pixels[..., :3], 1.0


def _loss(out, gt):
    per_ray = ((out["image"] - gt) ** 2).mean(-1)
    loss = per_ray.mean()
    if "deform_mean" in out:
        loss = loss + DEFORM_REG * out["deform_mean"]
    return loss, per_ray.detach()


def dnerf_loss(params, cfg: DNeRFConfig, batch: Dict, draws: Dict, *, num_steps: int = 512,
               min_near: float = 0.2):
    """(loss, aux) of one batch through ``render_rays_dnerf`` with jittered
    samples, differentiable in ``params``; aux holds ``per_ray_error`` [N]."""
    gt, bg = _gt_and_bg(batch["pixels"], draws["bg"])
    out = render_rays_dnerf(params, cfg, batch["rays_o"], batch["rays_d"], batch["time"], num_steps=num_steps,
                            perturb=True, z_noise=draws["z_noise"], bg_color=bg, min_near=min_near)
    loss, per_ray = _loss(out, gt)
    return loss, {"per_ray_error": per_ray}


def dnerf_loss_occupancy(params, cfg: DNeRFConfig, batch: Dict, occ: torch.Tensor, draws: Dict, *,
                         dt_gamma: float = 0.0, max_steps: int = 1024, slab: int = 64, min_near: float = 0.2,
                         T_thresh: float = 1e-4, skip_field: bool = False):
    """(loss, aux) of one batch through the time slot's march. ``occ`` is
    that slot's bool bitfield or, with ``skip_field``, its uint8 skip field.
    aux holds ``per_ray_error`` [N], ``n_samples`` [N] and ``march_iters``."""
    gt, bg = _gt_and_bg(batch["pixels"], draws["bg"])
    out = render_rays_dnerf_occupancy(
        params, cfg, batch["rays_o"], batch["rays_d"], batch["time"], occ, dt_gamma=dt_gamma,
        max_steps=max_steps, slab=slab, perturb=True, noise=draws["noise"], bg_color=bg, min_near=min_near,
        T_thresh=T_thresh, occ_skip=occ if skip_field else None,
    )
    loss, per_ray = _loss(out, gt)
    return loss, {"per_ray_error": per_ray, "n_samples": out["n_samples"], "march_iters": out["march_iters"]}


def dnerf_train_step(state: TrainState, batch: Dict, draws: Dict, *, cfg: DNeRFConfig, **kw) -> Dict:
    """One uniform-sampling optimizer step on ``state`` (updated in place)
    -> metrics: ``loss`` (a device scalar) and ``per_ray_error``. ``kw`` as
    ``dnerf_loss``."""
    loss, aux = dnerf_loss(state.params, cfg, batch, draws, **kw)
    loss.backward()
    state.apply_gradients()
    return {"loss": loss.detach(), "per_ray_error": aux["per_ray_error"]}


def dnerf_train_step_occupancy(state: TrainState, batch: Dict, occ: torch.Tensor, draws: Dict, *,
                               cfg: DNeRFConfig, **kw) -> Dict:
    """One occupancy optimizer step on ``state`` (updated in place) ->
    metrics: ``loss``, ``per_ray_error``, ``mean_samples`` and
    ``march_iters``. ``kw`` as ``dnerf_loss_occupancy``."""
    loss, aux = dnerf_loss_occupancy(state.params, cfg, batch, occ, draws, **kw)
    loss.backward()
    state.apply_gradients()
    return {
        "loss": loss.detach(),
        "per_ray_error": aux["per_ray_error"],
        "mean_samples": aux["n_samples"].float().mean(),
        "march_iters": aux["march_iters"],
    }
