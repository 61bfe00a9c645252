"""Multi-object field wrapper: per-point max-density fusion as a field fn.

Twin of focnerf_tpu/models/multiobject.py (the reference's
nerf/multiobjectnetwork.py ``MONeRFNetwork``, :43-95): density and color
loop over the K objects and keep, per sample, the object of the largest
sigma. A Python loop over the objects replaces ``lax.scan``. The selection
is strict (``>``): on equal sigma the earlier object wins, and a sample
where no object has sigma > 0 keeps the zero initial value.

``stacked_params`` is the list of K param dicts of
``render.compose.stack_object_params``.
"""

from __future__ import annotations

from typing import Optional

import torch

from focnerf_tpu_torch.models.nerf import NeRFConfig, color_fn, density_fn, encode_objfeat


def mo_density_fn(stacked_params, cfg: NeRFConfig, x: torch.Tensor):
    """Fused (sigma, geo_feat): both from the argmax-sigma object."""
    best_sigma = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    best_geo = torch.zeros(x.shape[:-1] + (cfg.geo_feat_dim,), dtype=torch.float32, device=x.device)
    for params_k in stacked_params:
        sigma_k, geo_k = density_fn(params_k, cfg, x)
        take = sigma_k > best_sigma
        best_sigma = torch.where(take, sigma_k, best_sigma)
        best_geo = torch.where(take[..., None], geo_k, best_geo)
    return best_sigma, best_geo


def mo_field_fn(
    stacked_params,
    cfg: NeRFConfig,
    x: torch.Tensor,
    d: torch.Tensor,
    obj_feats: Optional[torch.Tensor] = None,  # [K, F]
):
    """Fused (sigma, rgb): the argmax-sigma object gives both."""
    best_sigma = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    best_rgb = torch.zeros(x.shape[:-1] + (3,), dtype=torch.float32, device=x.device)
    for k, params_k in enumerate(stacked_params):
        sigma_k, geo_k = density_fn(params_k, cfg, x)
        enc = encode_objfeat(params_k, cfg, obj_feats[k]) if cfg.use_objfeat else None
        rgb_k = color_fn(params_k, cfg, d, geo_k, enc)
        take = sigma_k > best_sigma
        best_sigma = torch.where(take, sigma_k, best_sigma)
        best_rgb = torch.where(take[..., None], rgb_k, best_rgb)
    return best_sigma, best_rgb
