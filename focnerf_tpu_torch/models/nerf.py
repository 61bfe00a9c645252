"""The FOC-NeRF field: hash grid + sigma MLP + SH + object-conditioned color MLP.

Twin of focnerf_tpu/models/nerf.py. Params are a plain dict of tensors, with
the same keys and [in, out] weight layout as the JAX pytree:
``grid``, ``sigma_net``, ``color_net``, ``yolo_net`` and, when
``bg_radius > 0``, ``bg_grid`` and ``bg_net``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch

from focnerf_tpu_torch.models.mlp import mlp_apply, mlp_init
from focnerf_tpu_torch.ops.activation import trunc_exp
from focnerf_tpu_torch.ops.hashgrid import HashGridSpec, hashgrid_encode, hashgrid_encode_c2f, hashgrid_init
from focnerf_tpu_torch.ops.sh import sh_encode

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class NeRFConfig:
    """Same fields as the JAX NeRFConfig (so ``model_config.json`` round-trips);
    ``compute_dtype`` is a torch dtype. ``stochastic_corners`` and
    ``stochastic_min_size`` shape the training encode (``density_fn`` with
    ``u``). ``-O2``'s levers, set per step by the trainer: ``grad_levels``
    (the levels whose table rows get a gradient) and ``active_levels`` (a
    coarse-to-fine stage: only the first N levels are encoded; 0 = all).
    Eval paths use the full config."""

    bound: float = 1.0
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    num_layers: int = 2
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    sh_degree: int = 4
    yolo_feats_dim: int = 144
    yolo_encoding_dim: int = 16
    yolo_hidden_dim: int = 16
    use_objfeat: bool = True
    density_scale: float = 1.0
    bg_radius: float = -1.0
    compute_dtype: Any = torch.bfloat16
    stochastic_corners: int = 0
    stochastic_min_size: int = 0
    grad_levels: Any = None
    active_levels: int = 0

    @property
    def grid_spec(self) -> HashGridSpec:
        spec = _grid_spec(
            self.num_levels, self.level_dim, self.base_resolution,
            self.log2_hashmap_size, 2048.0 * self.bound,
        )
        if self.stochastic_corners:
            spec = dataclasses.replace(
                spec, stochastic_k=self.stochastic_corners,
                stochastic_min_size=self.stochastic_min_size,
            )
        if self.grad_levels is not None:
            spec = dataclasses.replace(spec, grad_levels=tuple(self.grad_levels))
        return spec

    @property
    def encode_spec(self) -> HashGridSpec:
        """The spec ``density_fn`` encodes with: the stage's truncated one
        under coarse-to-fine, which sizes the stochastic draws ``u``."""
        spec = self.grid_spec
        if 0 < self.active_levels < spec.num_levels:
            spec = spec.truncate(self.active_levels)
        return spec

    @property
    def bg_grid_spec(self) -> HashGridSpec:
        return _grid_spec(4, self.level_dim, 16, self.log2_hashmap_size, 2048.0, input_dim=2)

    @property
    def sh_dim(self) -> int:
        return self.sh_degree**2

    @property
    def color_in_dim(self) -> int:
        d = self.sh_dim + self.geo_feat_dim
        if self.use_objfeat:
            d += self.yolo_encoding_dim
        return d

    def net_dims(self) -> Dict[str, list]:
        """Layer sizes of every MLP in the params dict."""
        dims = {
            "sigma_net": [self.grid_spec.output_dim]
            + [self.hidden_dim] * (self.num_layers - 1)
            + [1 + self.geo_feat_dim],
            "color_net": [self.color_in_dim]
            + [self.hidden_dim_color] * (self.num_layers_color - 1)
            + [3],
        }
        if self.use_objfeat:
            dims["yolo_net"] = [self.yolo_feats_dim, self.yolo_hidden_dim, self.yolo_encoding_dim]
        if self.bg_radius > 0:
            dims["bg_net"] = [self.bg_grid_spec.output_dim + self.sh_dim, 64, 3]
        return dims


@functools.lru_cache(maxsize=None)
def _grid_spec(num_levels, level_dim, base_res, log2_size, desired_res, input_dim=3):
    return HashGridSpec.create(
        num_levels=num_levels,
        level_dim=level_dim,
        base_resolution=base_res,
        log2_hashmap_size=log2_size,
        desired_resolution=desired_res,
        input_dim=input_dim,
    )


def init_nerf_params(generator: torch.Generator, cfg: NeRFConfig, device) -> Params:
    """Seeded params: U(-1e-4, 1e-4) tables, Kaiming-uniform bias-free MLPs."""
    params: Params = {"grid": hashgrid_init(cfg.grid_spec, generator, device)}
    for name, dims in cfg.net_dims().items():
        params[name] = mlp_init(generator, dims, device)
    if cfg.bg_radius > 0:
        params["bg_grid"] = hashgrid_init(cfg.bg_grid_spec, generator, device)
    return params


def density_fn(params: Params, cfg: NeRFConfig, x: torch.Tensor, u: Optional[torch.Tensor] = None):
    """x [..., 3] in [-bound, bound] -> (sigma [...], geo_feat [..., geo]).

    ``u`` (training) holds the stochastic-corner draws of the encode,
    [x.numel() // 3, n_stoch, K, 3] of ``cfg.encode_spec``; without it the
    encode is exact. ``cfg.active_levels`` encodes a coarse-to-fine stage."""
    x01 = (x + cfg.bound) / (2.0 * cfg.bound)
    feats = hashgrid_encode_c2f(params["grid"], x01, cfg.grid_spec, cfg.active_levels, u)
    h = mlp_apply(params["sigma_net"], feats, cfg.compute_dtype)
    return trunc_exp(h[..., 0]), h[..., 1:]


def encode_objfeat(params: Params, cfg: NeRFConfig, raw_obj_feat: torch.Tensor) -> torch.Tensor:
    """Raw per-image YOLO backbone feature [..., 144] -> [..., 16] embedding."""
    return mlp_apply(params["yolo_net"], raw_obj_feat, cfg.compute_dtype)


def color_fn(
    params: Params,
    cfg: NeRFConfig,
    d: torch.Tensor,
    geo_feat: torch.Tensor,
    objfeat_enc: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Unit directions d [..., 3] + geo features (+ object embedding) -> rgb."""
    sh = sh_encode(d, cfg.sh_degree)
    parts = [sh, geo_feat]
    if cfg.use_objfeat:
        if objfeat_enc is None:
            raise ValueError("model configured with use_objfeat=True needs objfeat_enc")
        parts.append(objfeat_enc.expand(*sh.shape[:-1], cfg.yolo_encoding_dim))
    h = torch.cat([p.float() for p in parts], dim=-1)
    return torch.sigmoid(mlp_apply(params["color_net"], h, cfg.compute_dtype))


def background_fn(params: Params, cfg: NeRFConfig, sph: torch.Tensor, d: torch.Tensor):
    """Background color from sphere coords sph [..., 2] in [-1,1] + viewdir."""
    x01 = (sph + 1.0) / 2.0
    feats = hashgrid_encode(params["bg_grid"], x01, cfg.bg_grid_spec)
    h = torch.cat([feats, sh_encode(d, cfg.sh_degree)], dim=-1)
    return torch.sigmoid(mlp_apply(params["bg_net"], h, cfg.compute_dtype))
