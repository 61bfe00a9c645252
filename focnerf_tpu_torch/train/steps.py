"""The train steps: uniform sampling, occupancy marching and CLIP guidance.

Twin of focnerf_tpu/train/steps.py (nerf/utils.py:796-905):
``train_step`` is ``make_train_step`` (uniform samples with importance
upsampling, the reference's training without --cuda_ray),
``train_step_occupancy`` is ``make_train_step_occupancy`` (--cuda_ray) and
``make_clip_step`` is ``make_clip_step`` (the GT-free rand-pose step: an
H x W image from a random pose through ``render_rays``, white background,
loss ``clip_weight * clip_loss(image)``, then the same Adam and EMA). The
first two:

  - RGBA ground truth is composited onto a per-pixel random background;
  - loss = per-ray mean-channel MSE, plus ``alpha_weight`` * MSE of the
    weights sum against GT alpha, plus ``mask_penalty`` * ||sigma outside the
    object mask|| (``_safe_norm``: finite gradient at zero), plus
    ``tv_weight`` * the hash table's total variation at random points
    (``_tv_term``);
  - one autograd backward (the hash table's gradient through the scatter
    kernel, the composite's through its backward kernel on the card), then
    ``TrainState.apply_gradients`` (clip, Adam, LR schedule, EMA);
  - the per-ray error feeds ``update_error_map``, the error map's EMA.

torch cannot reproduce the JAX PRNG, so a step takes its draws as tensors;
``step_draws`` and ``uniform_step_draws`` make them from a
``torch.Generator`` in the JAX step's shapes: ``bg`` [N, 3], the march
jitter ``noise`` [N] or the sample jitter ``z_noise`` [N, num_steps] and
quantiles ``pdf_u`` [N, upsample_steps], the stochastic-corner uniforms
``u`` [points, n_stoch, K, 3] of ``cfg.encode_spec`` (a coarse-to-fine
stage's truncated spec), and with TV the points ``tv_x`` [8192, 3];
``clip_step_draws`` the CLIP step's ``z_noise`` and ``u``.
"""

from __future__ import annotations

from typing import Dict

import torch

from focnerf_tpu_torch.models.nerf import NeRFConfig
from focnerf_tpu_torch.ops.hashgrid import hashgrid_tv_loss, stochastic_levels
from focnerf_tpu_torch.render.renderer import render_rays, render_rays_occupancy
from focnerf_tpu_torch.train.state import TrainState

TV_POINTS = 8192  # random points of the TV term (JAX _tv_term's n_points)


def _safe_norm(x):
    """||x||_2 with a finite gradient at the zero vector."""
    return torch.sqrt((x * x).sum() + 1e-12)


def _corner_draws(generator: torch.Generator, cfg: NeRFConfig, n_points: int, device) -> torch.Tensor:
    spec = cfg.encode_spec
    shape = (n_points, len(stochastic_levels(spec)), spec.stochastic_k, spec.input_dim)
    return torch.rand(shape, generator=generator, device=device)


def step_draws(generator: torch.Generator, cfg: NeRFConfig, n_rays: int, slab: int, device,
               tv: bool = False) -> Dict:
    """The random draws of one occupancy train step, in the JAX step's shapes."""
    kw = dict(generator=generator, device=device)
    draws = {
        "bg": torch.rand((n_rays, 3), **kw),
        "noise": torch.rand((n_rays,), **kw),
        "u": _corner_draws(generator, cfg, n_rays * slab, device),
    }
    if tv:
        draws["tv_x"] = torch.rand((TV_POINTS, 3), **kw)
    return draws


def uniform_step_draws(generator: torch.Generator, cfg: NeRFConfig, n_rays: int, num_steps: int,
                       upsample_steps: int, device, tv: bool = False) -> Dict:
    """The random draws of one uniform train step, in the JAX step's shapes."""
    kw = dict(generator=generator, device=device)
    draws = {
        "bg": torch.rand((n_rays, 3), **kw),
        "z_noise": torch.rand((n_rays, num_steps), **kw),
        "pdf_u": torch.rand((n_rays, upsample_steps), **kw),
        "u": _corner_draws(generator, cfg, n_rays * (num_steps + upsample_steps), device),
    }
    if tv:
        draws["tv_x"] = torch.rand((TV_POINTS, 3), **kw)
    return draws


def clip_step_draws(generator: torch.Generator, cfg: NeRFConfig, n_rays: int, num_steps: int, device) -> Dict:
    """The random draws of one CLIP step (the sample jitter and the corner
    draws of ``render_rays``), in the JAX step's shapes."""
    return {
        "z_noise": torch.rand((n_rays, num_steps), generator=generator, device=device),
        "u": _corner_draws(generator, cfg, n_rays * num_steps, device),
    }


def _tv_term(cfg: NeRFConfig, params, draws: Dict, tv_weight: float):
    """``tv_weight`` * the table's total variation at the points ``tv_x``
    (gridencoder.cu:628-643; the reference samples random points)."""
    if tv_weight <= 0.0:
        return 0.0
    return tv_weight * hashgrid_tv_loss(params["grid"], draws["tv_x"], cfg.grid_spec)


def _target(cfg: NeRFConfig, batch: Dict, draws: Dict, color_space: str):
    """(pixels, background, RGB target) of a batch: RGBA composited onto
    the per-pixel random background ``bg``."""
    pixels = batch["pixels"]
    if color_space == "linear":
        from focnerf_tpu_torch.utils.color import srgb_to_linear

        pixels = torch.cat([srgb_to_linear(pixels[..., :3]), pixels[..., 3:]], -1)
    if pixels.shape[-1] == 4 and cfg.bg_radius <= 0:
        bg = draws["bg"]
        return pixels, bg, pixels[..., :3] * pixels[..., 3:] + bg * (1.0 - pixels[..., 3:])
    return pixels, 1.0, pixels[..., :3]


def _loss(cfg: NeRFConfig, params, batch: Dict, draws: Dict, pixels, gt, out, *, mask_penalty: float,
          alpha_weight: float, tv_weight: float, norm_fn=_safe_norm):
    """(loss, per-ray error [N]) of a rendered batch ``out``. ``norm_fn`` is
    the mask penalty's norm (the data-parallel step's spans every rank's
    rows)."""
    per_ray = ((out["image"] - gt) ** 2).mean(-1)
    loss = per_ray.mean()
    if alpha_weight > 0.0 and pixels.shape[-1] == 4:
        loss = loss + alpha_weight * ((out["weights_sum"] - pixels[..., 3]) ** 2).mean()
    ray_mask = batch.get("ray_mask")
    if ray_mask is not None:
        outside = torch.where(ray_mask[:, None], torch.zeros_like(out["sigmas"]), out["sigmas"])
        loss = loss + mask_penalty * norm_fn(outside)
    return loss + _tv_term(cfg, params, draws, tv_weight), per_ray.detach()


def uniform_loss(
    params,
    cfg: NeRFConfig,
    batch: Dict,
    draws: Dict,
    *,
    num_steps: int = 512,
    upsample_steps: int = 0,
    min_near: float = 0.2,
    mask_penalty: float = 1e-8,
    color_space: str = "srgb",
    alpha_weight: float = 0.0,
    tv_weight: float = 0.0,
    norm_fn=_safe_norm,
):
    """(loss, aux) of one batch through ``render_rays`` with jittered
    samples, differentiable in ``params``; aux holds ``per_ray_error`` [N]."""
    pixels, bg, gt = _target(cfg, batch, draws, color_space)
    out = render_rays(
        params, cfg, batch["rays_o"], batch["rays_d"], num_steps=num_steps,
        upsample_steps=upsample_steps, bg_color=bg, min_near=min_near,
        obj_feat=batch.get("obj_feat"), perturb=True, z_noise=draws["z_noise"],
        pdf_u=draws.get("pdf_u"), u=draws.get("u"),
    )
    loss, per_ray = _loss(cfg, params, batch, draws, pixels, gt, out, mask_penalty=mask_penalty,
                          alpha_weight=alpha_weight, tv_weight=tv_weight, norm_fn=norm_fn)
    return loss, {"per_ray_error": per_ray}


def _apply(state: TrainState, hyper):
    """The optimizer update: one whole step (``apply_gradients``), or with
    ``hyper`` (``TrainState.hyper``'s factors, staged by the fused chunk)
    only the device work, the host counters moving after the chunk."""
    if hyper is None:
        state.apply_gradients()
    else:
        state.update(hyper)


def train_step(state: TrainState, batch: Dict, draws: Dict, *, cfg: NeRFConfig, hyper=None, **kw) -> Dict:
    """One uniform-sampling optimizer step on ``state`` (updated in place)
    -> metrics: ``loss`` (a device scalar) and ``per_ray_error``. ``kw`` as
    ``uniform_loss``; ``hyper`` as ``_apply``."""
    loss, aux = uniform_loss(state.params, cfg, batch, draws, **kw)
    loss.backward()
    _apply(state, hyper)
    return {"loss": loss.detach(), "per_ray_error": aux["per_ray_error"]}


def update_error_map(error_map: torch.Tensor, inds_coarse: torch.Tensor, per_ray_error: torch.Tensor):
    """The error map's EMA at the sampled cells (nerf/utils.py:884-899):
    0.1 * old + 0.9 * this step's per-ray error -> a new map."""
    out = error_map.clone()
    out[inds_coarse] = 0.1 * error_map[inds_coarse] + 0.9 * per_ray_error
    return out


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
    tv_weight: float = 0.0,
    norm_fn=_safe_norm,
):
    """(loss, aux) of one batch, differentiable in ``params``. ``occ`` is the
    bool bitfield or, with ``skip_field``, the uint8 skip field. aux holds
    ``per_ray_error`` [N], ``n_samples`` [N] and ``march_iters``."""
    pixels, bg, gt = _target(cfg, batch, draws, color_space)
    out = render_rays_occupancy(
        params, cfg, batch["rays_o"], batch["rays_d"], occ,
        dt_gamma=dt_gamma, max_steps=max_steps, slab=slab, bg_color=bg, min_near=min_near,
        T_thresh=T_thresh, obj_feat=batch.get("obj_feat"),
        occ_skip=occ if skip_field else None,
        perturb=True, noise=draws["noise"], u=draws["u"],
    )
    loss, per_ray = _loss(cfg, params, batch, draws, pixels, gt, out, mask_penalty=mask_penalty,
                          alpha_weight=alpha_weight, tv_weight=tv_weight, norm_fn=norm_fn)
    aux = {
        "per_ray_error": per_ray,
        "n_samples": out["n_samples"],
        "march_iters": out["march_iters"],
    }
    return loss, aux


def train_step_occupancy(
    state: TrainState, batch: Dict, occ: torch.Tensor, draws: Dict, *, cfg: NeRFConfig, hyper=None, **kw
) -> Dict:
    """One optimizer step on ``state`` (updated in place) -> metrics:
    ``loss`` (a device scalar: reading it syncs), ``per_ray_error``,
    ``mean_samples``, and ``march_iters`` (the walk's iterations: a host
    int from the plain walk, a device scalar from the kernel). ``kw`` as
    ``occupancy_loss``; ``hyper`` as ``_apply``."""
    loss, aux = occupancy_loss(state.params, cfg, batch, occ, draws, **kw)
    loss.backward()
    _apply(state, hyper)
    return {
        "loss": loss.detach(),
        "per_ray_error": aux["per_ray_error"],
        "mean_samples": aux["n_samples"].float().mean(),
        "march_iters": aux["march_iters"],
    }


def clip_step_loss(params, cfg: NeRFConfig, rays_o, rays_d, draws: Dict, clip_loss, *, H: int, W: int,
                   num_steps: int = 128, min_near: float = 0.2, clip_weight: float = 1.0):
    """``clip_weight * clip_loss(image)`` of the H x W render of rays [H * W,
    3] (jittered by ``draws``, white background), differentiable in
    ``params``. Like JAX's, it passes no object feature: a config with
    ``use_objfeat`` raises in ``render_rays``."""
    out = render_rays(
        params, cfg, rays_o, rays_d, num_steps=num_steps, bg_color=1.0, min_near=min_near,
        perturb=True, z_noise=draws["z_noise"], u=draws.get("u"),
    )
    return clip_weight * clip_loss(out["image"].reshape(H, W, 3))


def make_clip_step(cfg: NeRFConfig, clip_loss, *, H: int, W: int, num_steps: int = 128,
                   min_near: float = 0.2, clip_weight: float = 1.0):
    """The CLIP-guided GT-free step (nerf/utils.py:796-838): ``step(state,
    rays_o, rays_d, draws)`` -> metrics {"loss"}, ``state`` updated in place
    (Adam, LR schedule and EMA, as every step). ``clip_loss`` maps an image
    [H, W, 3] in [0, 1] to a differentiable scalar
    (``clip_guidance.make_torch_clip_loss``, or any stand-in)."""

    def step(state: TrainState, rays_o, rays_d, draws: Dict) -> Dict:
        loss = clip_step_loss(state.params, cfg, rays_o, rays_d, draws, clip_loss, H=H, W=W,
                              num_steps=num_steps, min_near=min_near, clip_weight=clip_weight)
        loss.backward()
        state.apply_gradients()
        return {"loss": loss.detach()}

    return step
