"""The occupancy train step (the reference's --cuda_ray training).

Twin of focnerf_tpu/train/steps.py::make_train_step_occupancy
(nerf/utils.py:818-905):

  - RGBA ground truth is composited onto a per-pixel random background;
  - loss = per-ray mean-channel MSE, plus ``alpha_weight`` * MSE of the
    weights sum against GT alpha, plus ``mask_penalty`` * ||sigma outside the
    object mask|| (``_safe_norm``: finite gradient at zero);
  - one autograd backward (the hash table's gradient through the scatter
    kernel, the composite's through its backward kernel on the card), then
    ``TrainState.apply_gradients`` (clip, Adam, LR schedule, EMA).

torch cannot reproduce the JAX PRNG, so the step takes its draws as tensors
(``draws``: ``bg`` [N, 3], march jitter ``noise`` [N], stochastic-corner
uniforms ``u`` [N * slab, n_stoch, K, 3]); ``step_draws`` makes them from a
``torch.Generator``. The TV term and the error map are not ported.
"""

from __future__ import annotations

from typing import Dict

import torch

from focnerf_tpu_torch.models.nerf import NeRFConfig
from focnerf_tpu_torch.ops.hashgrid import stochastic_levels
from focnerf_tpu_torch.render.renderer import render_rays_occupancy
from focnerf_tpu_torch.train.state import TrainState


def _safe_norm(x):
    """||x||_2 with a finite gradient at the zero vector."""
    return torch.sqrt((x * x).sum() + 1e-12)


def step_draws(generator: torch.Generator, cfg: NeRFConfig, n_rays: int, slab: int, device) -> Dict:
    """The random draws of one train step, in the JAX step's shapes."""
    spec = cfg.grid_spec
    kw = dict(generator=generator, device=device)
    n_stoch = len(stochastic_levels(spec))
    return {
        "bg": torch.rand((n_rays, 3), **kw),
        "noise": torch.rand((n_rays,), **kw),
        "u": torch.rand((n_rays * slab, n_stoch, spec.stochastic_k, spec.input_dim), **kw),
    }


def occupancy_loss(
    params,
    cfg: NeRFConfig,
    batch: Dict,
    occ: torch.Tensor,
    draws: Dict,
    *,
    dt_gamma: float = 1 / 128,
    max_steps: int = 1024,
    slab: int = 128,
    min_near: float = 0.2,
    mask_penalty: float = 1e-8,
    color_space: str = "srgb",
    T_thresh: float = 1e-4,
    alpha_weight: float = 0.0,
    skip_field: bool = False,
):
    """(loss, aux) of one batch, differentiable in ``params``. ``occ`` is the
    bool bitfield or, with ``skip_field``, the uint8 skip field. aux holds
    ``per_ray_error`` [N], ``n_samples`` [N] and ``march_iters``."""
    pixels = batch["pixels"]
    if color_space == "linear":
        from focnerf_tpu_torch.utils.color import srgb_to_linear

        pixels = torch.cat([srgb_to_linear(pixels[..., :3]), pixels[..., 3:]], -1)
    c = pixels.shape[-1]
    if c == 4 and cfg.bg_radius <= 0:
        bg = draws["bg"]
        gt = pixels[..., :3] * pixels[..., 3:] + bg * (1.0 - pixels[..., 3:])
    else:
        bg = 1.0
        gt = pixels[..., :3]
    out = render_rays_occupancy(
        params, cfg, batch["rays_o"], batch["rays_d"], occ,
        dt_gamma=dt_gamma, max_steps=max_steps, slab=slab, bg_color=bg, min_near=min_near,
        T_thresh=T_thresh, obj_feat=batch.get("obj_feat"),
        occ_skip=occ if skip_field else None,
        perturb=True, noise=draws["noise"], u=draws["u"],
    )
    per_ray = ((out["image"] - gt) ** 2).mean(-1)
    loss = per_ray.mean()
    if alpha_weight > 0.0 and c == 4:
        loss = loss + alpha_weight * ((out["weights_sum"] - pixels[..., 3]) ** 2).mean()
    ray_mask = batch.get("ray_mask")
    if ray_mask is not None:
        outside = torch.where(ray_mask[:, None], torch.zeros_like(out["sigmas"]), out["sigmas"])
        loss = loss + mask_penalty * _safe_norm(outside)
    aux = {
        "per_ray_error": per_ray.detach(),
        "n_samples": out["n_samples"],
        "march_iters": out["march_iters"],
    }
    return loss, aux


def train_step_occupancy(
    state: TrainState, batch: Dict, occ: torch.Tensor, draws: Dict, *, cfg: NeRFConfig, **kw
) -> Dict:
    """One optimizer step on ``state`` (updated in place) -> metrics:
    ``loss`` (a device scalar: reading it syncs), ``per_ray_error``,
    ``mean_samples``, and ``march_iters`` (a host int). ``kw`` as
    ``occupancy_loss``."""
    loss, aux = occupancy_loss(state.params, cfg, batch, occ, draws, **kw)
    loss.backward()
    state.apply_gradients()
    return {
        "loss": loss.detach(),
        "per_ray_error": aux["per_ray_error"],
        "mean_samples": aux["n_samples"].float().mean(),
        "march_iters": aux["march_iters"],
    }
