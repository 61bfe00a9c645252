"""Dynamic NeRF (D-NeRF) fields: deform, temporal basis and hyper.

Twin of focnerf_tpu/models/dnerf.py, with the same params keys and [in,
out] weight layout:

  - ``deform``: a ``deform_layers`` x ``deform_hidden`` MLP warps x by
    dx(freq(x), freq(t)); the sigma net reads hash(x + dx) + freq(x) +
    freq(t). The encode gives the warped points their gradient, so the
    deformation net learns from the image loss;
  - ``basis``: a time MLP gives softmax coefficients over ``n_basis``
    channels of the sigma and color heads;
  - ``hyper``: a hyper MLP lifts (x, t) to ``hyper_dim`` ambient
    coordinates in [0, 1], appended to x for a (3 + hyper_dim)-D hash grid,
    which also gives them their gradient.

The encode is always exact here: JAX passes no corner draws to these
fields, and its ``input_grads=True`` encode turns them off.
``density_fn``-style functions return the deformation as ``aux["deform"]``
for the trainer's L1 term.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from focnerf_tpu_torch.models.mlp import mlp_apply, mlp_init
from focnerf_tpu_torch.models.nerf import NeRFConfig, _grid_spec
from focnerf_tpu_torch.ops.activation import trunc_exp
from focnerf_tpu_torch.ops.freq import freq_encode, freq_output_dim
from focnerf_tpu_torch.ops.hashgrid import HashGridSpec, hashgrid_encode, hashgrid_init
from focnerf_tpu_torch.ops.sh import sh_encode

Params = Dict[str, Any]
VARIANTS = ("deform", "basis", "hyper")


@dataclasses.dataclass(frozen=True)
class DNeRFConfig(NeRFConfig):
    variant: str = "deform"  # deform | basis | hyper
    deform_layers: int = 5
    deform_hidden: int = 128
    freq_deg_x: int = 10
    freq_deg_t: int = 6
    n_basis: int = 4
    hyper_dim: int = 2

    @property
    def x_enc_dim(self) -> int:
        return freq_output_dim(3, self.freq_deg_x)

    @property
    def t_enc_dim(self) -> int:
        return freq_output_dim(1, self.freq_deg_t)

    @property
    def field_spec(self) -> HashGridSpec:
        """The spec of ``params["grid"]``: 3-D, or (3 + hyper_dim)-D for
        ``hyper``. Without stochastic corners: this field encodes exactly."""
        dim = 3 + self.hyper_dim if self.variant == "hyper" else 3
        return _grid_spec(self.num_levels, self.level_dim, self.base_resolution,
                          self.log2_hashmap_size, 2048.0 * self.bound, input_dim=dim)

    def net_dims(self) -> Dict[str, list]:
        """Layer sizes of every MLP, in the JAX params' key order."""
        if self.variant not in VARIANTS:
            raise ValueError(f"unknown dnerf variant {self.variant}")
        B = self.n_basis if self.variant == "basis" else 1
        enc = self.x_enc_dim + self.t_enc_dim
        sigma_in = self.field_spec.output_dim
        dims: Dict[str, list] = {}
        if self.variant == "deform":
            dims["deform_net"] = [enc] + [self.deform_hidden] * (self.deform_layers - 1) + [3]
            sigma_in += enc  # grid(x + dx) + freq(x) + freq(t)
        elif self.variant == "basis":
            dims["basis_net"] = [self.t_enc_dim, 128, self.n_basis]
        else:
            dims["hyper_net"] = [enc, self.deform_hidden, self.hyper_dim]
        dims["sigma_net"] = [sigma_in] + [self.hidden_dim] * (self.num_layers - 1) + [(1 + self.geo_feat_dim) * B]
        dims["color_net"] = ([self.sh_dim + self.geo_feat_dim] + [self.hidden_dim_color] * (self.num_layers_color - 1)
                             + [3 * B])
        return dims


def init_dnerf_params(generator: torch.Generator, cfg: DNeRFConfig, device) -> Params:
    """Seeded params (the table U(-1e-4, 1e-4), Kaiming-uniform MLPs), drawn
    on the CPU from ``generator`` in the JAX params' key order."""
    params: Params = {"grid": hashgrid_init(cfg.field_spec, generator, device)}
    for name, dims in cfg.net_dims().items():
        params[name] = mlp_init(generator, dims, device)
    return params


def _time_column(t, x: torch.Tensor) -> torch.Tensor:
    """Scalar time t (a number or a 0-d tensor) as a column [..., 1] beside x."""
    t = torch.as_tensor(t, dtype=torch.float32, device=x.device).reshape(1)
    return t.expand(*x.shape[:-1], 1)


def _warp(params: Params, cfg: DNeRFConfig, x: torch.Tensor, t):
    """(x + dx, dx, (freq(x), freq(t))) of the deformation net at time t."""
    ex = freq_encode(x, cfg.freq_deg_x)
    et = freq_encode(_time_column(t, x), cfg.freq_deg_t)
    deform = mlp_apply(params["deform_net"], torch.cat([ex, et], -1), cfg.compute_dtype)
    return x + deform, deform, (ex, et)


def dnerf_density(params: Params, cfg: DNeRFConfig, x: torch.Tensor, t):
    """x [..., 3] in [-bound, bound] at time t in [0, 1] -> (sigma [...],
    geo_feat [..., geo], aux): ``aux["deform"]`` (deform) or
    ``aux["basis_coeff"]`` [n_basis] (basis)."""
    aux: Dict[str, Any] = {}
    spec = cfg.field_spec
    if cfg.variant == "deform":
        xw, deform, (ex, et) = _warp(params, cfg, x, t)
        aux["deform"] = deform
        feats = hashgrid_encode(params["grid"], (xw + cfg.bound) / (2 * cfg.bound), spec)
        h = mlp_apply(params["sigma_net"], torch.cat([feats, ex, et], -1), cfg.compute_dtype)
        return trunc_exp(h[..., 0]), h[..., 1:], aux
    if cfg.variant == "hyper":
        ex = freq_encode(x, cfg.freq_deg_x)
        et = freq_encode(_time_column(t, x), cfg.freq_deg_t)
        hyper01 = torch.sigmoid(mlp_apply(params["hyper_net"], torch.cat([ex, et], -1), cfg.compute_dtype))
        x01 = (x + cfg.bound) / (2 * cfg.bound)
        feats = hashgrid_encode(params["grid"], torch.cat([x01, hyper01], -1), spec)
        h = mlp_apply(params["sigma_net"], feats, cfg.compute_dtype)
        return trunc_exp(h[..., 0]), h[..., 1:], aux
    if cfg.variant != "basis":
        raise ValueError(f"unknown dnerf variant {cfg.variant}")
    feats = hashgrid_encode(params["grid"], (x + cfg.bound) / (2 * cfg.bound), spec)
    h = mlp_apply(params["sigma_net"], feats, cfg.compute_dtype)  # [..., (1 + G) * B]
    tt = torch.as_tensor(t, dtype=torch.float32, device=x.device).reshape(1)
    coeff = mlp_apply(params["basis_net"], freq_encode(tt, cfg.freq_deg_t), cfg.compute_dtype)
    coeff = torch.softmax(coeff.reshape(-1), dim=-1)  # [B]
    h = h.reshape(*h.shape[:-1], 1 + cfg.geo_feat_dim, cfg.n_basis) @ coeff
    aux["basis_coeff"] = coeff
    return trunc_exp(h[..., 0]), h[..., 1:], aux


def dnerf_color(params: Params, cfg: DNeRFConfig, d: torch.Tensor, geo_feat: torch.Tensor,
                basis_coeff: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Unit directions d [..., 3] + geo features -> rgb [..., 3] (the basis
    variant mixes its ``n_basis`` colors by ``basis_coeff``)."""
    h = torch.cat([sh_encode(d, cfg.sh_degree), geo_feat.float()], dim=-1)
    out = mlp_apply(params["color_net"], h, cfg.compute_dtype)
    if cfg.variant == "basis":
        if basis_coeff is None:
            raise ValueError("the basis variant needs its basis_coeff")
        out = out.reshape(*out.shape[:-1], 3, cfg.n_basis) @ basis_coeff
    return torch.sigmoid(out)


def dnerf_field(params: Params, cfg: DNeRFConfig, x: torch.Tensor, d: torch.Tensor, t):
    sigma, geo, aux = dnerf_density(params, cfg, x, t)
    return sigma, dnerf_color(params, cfg, d, geo, aux.get("basis_coeff")), aux
