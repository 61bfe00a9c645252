"""Conversions between the JAX package's saved state and the port's.

  - ``params_from_jax``: the JAX param pytree (``grid`` [rows, C];
    ``sigma_net``/``color_net``/``yolo_net`` as lists of [in, out];
    ``bg_grid``/``bg_net`` when ``bg_radius > 0``; models/nerf.py:135-155),
    given as numpy arrays, -> the port's dict of tensors, checked against
    the config's shapes;
  - ``occupancy_from_jax``: ``density_grid`` [CAS, H^3], ``mean_density``,
    ``iter_density`` -> ``OccupancyState``;
  - ``train_state_from_jax``: a JAX ``TrainState`` (params, the optax Adam
    moments ``mu``/``nu`` and ``count``, EMA params, ``ema_count``, step)
    -> the port's ``TrainState``, so a JAX run resumes in the port;
  - ``baked_volume_from_jax``: a JAX ``BakedVolume`` or ``QuantizedVolume``
    (render/baked.py, numpy-convertible fields) -> the port's;
  - ``voxel_field_from_jax``, ``vm_field_from_jax``, ``dyn_field_from_jax``,
    ``kplanes_field_from_jax``: the voxel families' parameters (a raw grid,
    or the family's NamedTuple of arrays) -> the port's tensors;
  - ``dnerf_params_from_jax``: the D-NeRF param pytree (``grid``, 3-D or
    the hyper variant's 5-D; ``deform_net``/``basis_net``/``hyper_net``;
    ``sigma_net``, ``color_net``; models/dnerf.py:66-106) -> the port's;
  - ``time_occupancy_from_jax``: ``density_grid`` [T_slots, CAS, H^3],
    ``mean_density``, ``iter_density`` -> ``TimeOccupancyState``;
  - ``config_to_dict``/``config_from_dict``: ``NeRFConfig`` or
    ``DNeRFConfig`` <-> the ``model_config.json`` dict that
    focnerf_tpu/train/checkpoints.py:29-63 writes (``__class__`` names it).

Only numpy arrays cross the boundary; this module imports no JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from focnerf_tpu_torch.models.nerf import NeRFConfig, Params
from focnerf_tpu_torch.ops.occupancy import OccupancyState, cascade_count
from focnerf_tpu_torch.train.state import TrainState, param_leaves

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def config_to_dict(cfg: NeRFConfig) -> dict:
    d = dataclasses.asdict(cfg)
    d["compute_dtype"] = "bfloat16" if cfg.compute_dtype == torch.bfloat16 else "float32"
    if d["grad_levels"] is not None:
        d["grad_levels"] = list(d["grad_levels"])
    d["__class__"] = type(cfg).__name__
    return d


def config_from_dict(d: Mapping[str, Any]) -> NeRFConfig:
    from focnerf_tpu_torch.models.dnerf import DNeRFConfig

    d = dict(d)
    cls_name = d.pop("__class__", "NeRFConfig")
    classes = {"NeRFConfig": NeRFConfig, "DNeRFConfig": DNeRFConfig}
    if cls_name not in classes:
        raise ValueError(f"only NeRFConfig and DNeRFConfig checkpoints are ported, got {cls_name}")
    d["compute_dtype"] = _DTYPES[d.get("compute_dtype", "float32")]
    if d.get("grad_levels") is not None:
        d["grad_levels"] = tuple(d["grad_levels"])
    return classes[cls_name](**d)


def _tensor(a, shape, name: str, device) -> torch.Tensor:
    arr = np.asarray(a, dtype=np.float32)
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {arr.shape}")
    return torch.from_numpy(arr.copy()).to(device)


def params_from_jax(tree: Mapping[str, Any], cfg: NeRFConfig, device) -> Params:
    """JAX param pytree (numpy leaves) -> the port's params on ``device``."""
    spec = cfg.grid_spec
    params: Params = {"grid": _tensor(tree["grid"], (spec.table_rows, spec.level_dim), "grid", device)}
    if cfg.bg_radius > 0:
        bg = cfg.bg_grid_spec
        params["bg_grid"] = _tensor(tree["bg_grid"], (bg.table_rows, bg.level_dim), "bg_grid", device)
    _nets_from_jax(params, tree, cfg.net_dims(), device)
    return params


def dnerf_params_from_jax(tree: Mapping[str, Any], cfg, device) -> Params:
    """JAX D-NeRF param pytree (numpy leaves) -> the port's params on
    ``device``, checked against the ``DNeRFConfig``'s shapes."""
    spec = cfg.field_spec
    params: Params = {"grid": _tensor(tree["grid"], (spec.table_rows, spec.level_dim), "grid", device)}
    _nets_from_jax(params, tree, cfg.net_dims(), device)
    return params


def _nets_from_jax(params: Params, tree, net_dims: dict, device):
    for name, dims in net_dims.items():
        ws = list(tree[name])
        if len(ws) != len(dims) - 1:
            raise ValueError(f"{name}: expected {len(dims) - 1} layers, got {len(ws)}")
        params[name] = [
            _tensor(w, (i, o), f"{name}[{k}]", device)
            for k, (w, i, o) in enumerate(zip(ws, dims[:-1], dims[1:]))
        ]


def time_occupancy_from_jax(occ: Mapping[str, Any], bound: float, time_slots: int, device,
                            grid_size: int = 128):
    """JAX TimeOccupancyState fields (numpy) -> the port's ``TimeOccupancyState``."""
    from focnerf_tpu_torch.render.dnerf_renderer import TimeOccupancyState

    shape = (time_slots, cascade_count(bound), grid_size**3)
    return TimeOccupancyState(
        density_grid=_tensor(occ["density_grid"], shape, "density_grid", device),
        mean_density=_tensor(occ["mean_density"], (), "mean_density", device),
        iter_density=torch.as_tensor(np.array(occ["iter_density"]), dtype=torch.int32).to(device),
    )


def occupancy_from_jax(occ: Mapping[str, Any], bound: float, device, grid_size: int = 128) -> OccupancyState:
    """JAX OccupancyState fields (numpy) -> the port's ``OccupancyState``."""
    shape = (cascade_count(bound), grid_size**3)
    return OccupancyState(
        density_grid=_tensor(occ["density_grid"], shape, "density_grid", device),
        mean_density=_tensor(occ["mean_density"], (), "mean_density", device),
        iter_density=torch.as_tensor(np.array(occ["iter_density"]), dtype=torch.int32).to(device),
    )


def train_state_from_jax(
    *, params, mu, nu, count, ema_params, ema_count, step, cfg: NeRFConfig, device, **state_kw
) -> TrainState:
    """The JAX TrainState's pieces (numpy pytrees and ints; ``mu``, ``nu``,
    ``count`` from optax's ScaleByAdamState) -> the port's ``TrainState`` on
    ``device``. ``state_kw`` (lr, iters, lr_net, warmup, grad_clip,
    ema_decay) must be the JAX run's optimizer settings. A ``DNeRFConfig``
    takes the D-NeRF params' layout."""
    from focnerf_tpu_torch.models.dnerf import DNeRFConfig

    params_from = dnerf_params_from_jax if isinstance(cfg, DNeRFConfig) else params_from_jax
    state = TrainState(params_from(params, cfg, device), **state_kw)
    moments = zip(param_leaves(params_from(mu, cfg, device)),
                  param_leaves(params_from(nu, cfg, device)))
    opt = state.optimizer.state_dict()
    opt["state"] = {
        i: {"step": torch.tensor(float(count)), "exp_avg": m, "exp_avg_sq": v}
        for i, (m, v) in enumerate(moments)
    }
    state.load_state_dict({
        "step": int(step),
        "params": params_from(params, cfg, device),
        "ema_params": params_from(ema_params, cfg, device),
        "ema_count": int(ema_count),
        "optimizer": opt,
    })
    return state


def baked_volume_from_jax(vol, device="cpu"):
    """A JAX ``BakedVolume`` or ``QuantizedVolume`` -> the port's on
    ``device``, with the same values and dtypes."""
    from focnerf_tpu_torch.render.baked import BakedVolume, QuantizedVolume

    to = lambda a: torch.from_numpy(np.array(a)).to(device)  # noqa: E731
    if hasattr(vol, "q"):
        return QuantizedVolume(q=to(vol.q), scales=to(vol.scales), los=to(vol.los),
                               bound=float(vol.bound), sh_deg=int(vol.sh_deg))
    return BakedVolume(rgba=to(vol.rgba), bound=float(vol.bound), sh_deg=int(vol.sh_deg))


def _field_from_jax(cls, field, device):
    return cls(*(torch.from_numpy(np.array(a, dtype=np.float32)).to(device) for a in field))


def voxel_field_from_jax(raw, device="cpu") -> torch.Tensor:
    """A JAX dense raw field [R, R, R, C] -> the port's tensor on ``device``."""
    return torch.from_numpy(np.array(raw, dtype=np.float32)).to(device)


def vm_field_from_jax(field, device="cpu"):
    """A JAX ``VMField`` (train/voxel_vm.py) -> the port's."""
    from focnerf_tpu_torch.train.voxel_vm import VMField

    return _field_from_jax(VMField, field, device)


def dyn_field_from_jax(field, device="cpu"):
    """A JAX ``DynVoxelField`` (train/voxel_dynamic.py) -> the port's."""
    from focnerf_tpu_torch.train.voxel_dynamic import DynVoxelField

    return _field_from_jax(DynVoxelField, field, device)


def kplanes_field_from_jax(field, device="cpu"):
    """A JAX ``KPlanesField`` (train/voxel_kplanes.py) -> the port's."""
    from focnerf_tpu_torch.train.voxel_kplanes import KPlanesField

    return _field_from_jax(KPlanesField, field, device)


def field_slab(raw: torch.Tensor, axis: int, index: int, count: int) -> torch.Tensor:
    """Slab ``index`` of ``count`` equal slabs of a full field [R, R, R, C]
    along spatial ``axis`` (the slice-parallel shard of that rank)."""
    R = raw.shape[axis]
    if R % count:
        raise ValueError(f"resolution {R} does not divide into {count} slabs")
    per = R // count
    return raw.narrow(axis, index * per, per).contiguous()


def join_field_slabs(slabs, axis: int) -> torch.Tensor:
    """The full field from its slabs in rank order (``field_slab``'s inverse)."""
    return torch.cat(list(slabs), dim=axis)
