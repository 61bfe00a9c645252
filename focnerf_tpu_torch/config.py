"""Unified option set for the CLIs.

Twin of focnerf_tpu/config.py: the same ``Options`` fields and flags (so a
command line written for the JAX package parses here), the same ``-O`` and
``-O2`` mapping (config.py:347-373), and ``nerf_config``/``dataset_options``
returning the port's types. ``-O2`` keeps JAX's override semantics: an
explicit ``--grad_level_phases 0`` becomes 2 and an empty ``--c2f`` the
default schedule (with at least 12 levels). Options of features the port
has not ported yet (rand-pose) are parsed and carried; the port's trainer
refuses rand-pose, and ``main_nerf`` says so for the option it ignores
(``--grid_int8``). ``--no-preload`` selects the host pipeline of the train
split (``dataset_options().host_pipeline``), as in JAX; ``-O`` forces
``preload``. ``dnerf_config`` gives ``main_dnerf``'s field.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional, Tuple

import torch


@dataclasses.dataclass
class Options:
    path: str = ""
    workspace: str = "workspace"
    seed: int = 0
    test: bool = False

    # training
    iters: int = 30000
    lr: float = 1e-2
    lr_net: float = 0.0
    lr_warmup: int = 0
    alpha_loss: float = 0.0
    grad_clip: float = 0.0
    grad_level_phases: int = 0
    c2f: str = ""
    ckpt: str = "latest"
    num_rays: int = 4096
    cuda_ray: bool = False  # kept name for parity; enables occupancy marching
    max_steps: int = 1024
    num_steps: int = 512
    upsample_steps: int = 0
    save_gt: bool = False
    ff: bool = False
    tcnn: bool = False
    post: bool = False
    basis: bool = False
    hyper: bool = False
    update_extra_interval: int = 16
    steps_per_dispatch: int = 1
    max_ray_batch: int = 4096
    eval_interval: int = 50
    ckpt_interval: int = 1
    eval_save_images: bool = True
    mesh_res: int = 256
    # the JAX package's test mode ignores this (its Trainer keeps "oneshot");
    # so does the port's
    eval_renderer: str = "iter"
    patch_size: int = 1
    train_slab: int = 128
    bucket_slabs: bool = False
    skip_march: bool = False

    # precision
    fp16: bool = False  # bf16 compute

    # dataset
    color_space: str = "srgb"
    preload: bool = True
    bound: float = 2.0
    scale: float = 0.33
    offset: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    dt_gamma: float = 1 / 128
    min_near: float = 0.2
    density_thresh: float = 10.0
    bg_radius: float = -1.0
    downscale: int = 1

    # GUI / viewer
    gui: bool = False
    W: int = 1920
    H: int = 1080
    radius: float = 5.0
    fovy: float = 50.0
    max_spp: int = 64

    # experimental
    error_map: bool = False
    clip_text: str = ""
    rand_pose: int = -1
    tv_weight: float = 0.0
    stochastic_corners: int = 0
    stochastic_min_size: int = 0
    grid_int8: bool = False
    grid_levels: int = 16
    grid_featdim: int = 2

    # yolo / objects / composition
    yolo_model: str = "yolov8s-seg.pt"
    disable_yolo: bool = False
    legacy: bool = False
    n_chunks: int = 5  # 0 turns off obj-feat conditioning
    bound_inf: Optional[Tuple[float, ...]] = None
    edit_x: float = 0.0
    ckpt_dir: str = ""
    objects_of_interest: List[str] = dataclasses.field(default_factory=list)
    mo_density_infer: bool = False

    # editing
    edit_object: str = ""
    offset_x: float = 0.0
    offset_y: float = 0.0
    offset_z: float = 0.0
    rotate_x: float = 0.0
    rotate_y: float = 0.0
    rotate_z: float = 0.0

    # baked real-time inference and voxel families
    baked: bool = False
    bake_res: int = 256
    bake_sh: int = 0
    bake_quantize: bool = False
    bake_gate: bool = True
    voxel_supervise: str = "intermediate"
    voxel_c2f: int = 1
    voxel_dynamic: bool = False
    voxel_rank: int = 4
    voxel_time_slots: int = 16
    voxel_time_smooth: float = 1e-3
    voxel_vm: int = 0
    voxel_kplanes: int = 0
    voxel_sp: bool = False
    voxel_dp: int = 0

    # dnerf
    dnerf_variant: str = "deform"
    time_slots: int = 64
    mesh_t: float = None

    @property
    def use_objfeat(self) -> bool:
        return self.n_chunks > 0

    def nerf_config(self, yolo_feats_dim: int = 144):
        from focnerf_tpu_torch.models.nerf import NeRFConfig

        return NeRFConfig(
            bound=self.bound,
            use_objfeat=self.use_objfeat,
            yolo_feats_dim=yolo_feats_dim,
            bg_radius=self.bg_radius,
            compute_dtype=torch.bfloat16 if self.fp16 else torch.float32,
            stochastic_corners=self.stochastic_corners,
            stochastic_min_size=self.stochastic_min_size,
            num_levels=self.grid_levels,
            level_dim=self.grid_featdim,
        )

    def dnerf_config(self):
        """The D-NeRF field main_dnerf trains (focnerf_tpu/config.py:257-270):
        no object features, bf16 under ``--fp16``. It carries the
        stochastic-corner fields, but its encode is exact (models/dnerf.py)."""
        from focnerf_tpu_torch.models.dnerf import DNeRFConfig

        return DNeRFConfig(
            bound=self.bound,
            variant=self.dnerf_variant,
            use_objfeat=False,
            bg_radius=self.bg_radius,
            compute_dtype=torch.bfloat16 if self.fp16 else torch.float32,
            stochastic_corners=self.stochastic_corners,
            stochastic_min_size=self.stochastic_min_size,
        )

    def dataset_options(self):
        from focnerf_tpu_torch.data.provider import DatasetOptions

        return DatasetOptions(
            path=self.path,
            scale=self.scale,
            offset=tuple(self.offset),
            downscale=self.downscale,
            num_rays=self.num_rays,
            preload_dtype="float16" if self.fp16 else "float32",
            edit_x=self.edit_x,
            rand_pose=self.rand_pose,
            radius=self.radius,
            error_map=self.error_map,
            patch_size=self.patch_size,
            # --no-preload: the train split stays on the host as uint8 and
            # the native threaded loader draws the batches
            host_pipeline=not self.preload,
        )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("path", type=str)
    p.add_argument("-O", action="store_true", help="equals --fp16 --cuda_ray --preload")
    p.add_argument("-O2", action="store_true",
                   help="-O plus --grad_level_phases 2 and --c2f 0.3:8,0.6:12")
    defaults = Options()
    for f in dataclasses.fields(Options):
        if f.name == "path":
            continue
        arg = f"--{f.name}"
        default = getattr(defaults, f.name)
        if isinstance(default, bool):
            p.add_argument(arg, action=argparse.BooleanOptionalAction, default=default)
        elif f.name in ("offset", "bound_inf", "objects_of_interest"):
            p.add_argument(arg, nargs="+", default=default)
        else:
            caster = float if f.name == "mesh_t" else (type(default) if default is not None else str)
            p.add_argument(arg, type=caster, default=default)
    return p


def parse_options(argv=None) -> Options:
    d = vars(build_parser().parse_args(argv))
    O2_flag = d.pop("O2", False)
    O_flag = d.pop("O", False) or O2_flag
    names = {f.name for f in dataclasses.fields(Options)}
    opt = Options(**{k: v for k, v in d.items() if k in names})
    if opt.offset is not None:
        opt.offset = tuple(float(x) for x in opt.offset)
    if opt.basis and opt.hyper:
        raise ValueError("--basis and --hyper are mutually exclusive")
    if opt.basis:
        opt.dnerf_variant = "basis"
    if opt.hyper:
        opt.dnerf_variant = "hyper"
    if opt.bound_inf is not None and not isinstance(opt.bound_inf, tuple):
        opt.bound_inf = tuple(float(x) for x in opt.bound_inf)
    if O_flag:
        opt.fp16 = True
        opt.cuda_ray = True
        opt.preload = True
        opt.stochastic_corners = 1
        opt.stochastic_min_size = 1
        opt.bucket_slabs = True
        opt.skip_march = True
    if O2_flag:
        if not opt.grad_level_phases:
            opt.grad_level_phases = 2
        if not opt.c2f and opt.grid_levels >= 12:
            opt.c2f = "0.3:8,0.6:12"
    return opt
