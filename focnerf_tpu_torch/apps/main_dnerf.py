"""D-NeRF CLI: train a dynamic scene, or render its test split across time.

Twin of focnerf_tpu/apps/main_dnerf.py: the ``deform``, ``basis`` or
``hyper`` field (``--dnerf_variant``, or ``--basis``/``--hyper``) trained
with per-frame times through ``DNeRFTrainer`` (resume, eval cadence,
checkpoints), with the time-axis occupancy grid under ``-O``/``--cuda_ray``
and uniform samples without it; after training, the val split evaluated
when the cadence eval did not run at the last step, and the meshes at t = 0
and t = 1 (or at ``--mesh_t``), at 128^3 and ``--density_thresh``.
``--test`` renders the test split across time to PNGs and an mp4.

Usage:
  python -m focnerf_tpu_torch.apps.main_dnerf <scene> -O --dnerf_variant deform --workspace ws
  python -m focnerf_tpu_torch.apps.main_dnerf <scene> -O --hyper --workspace ws
  python -m focnerf_tpu_torch.apps.main_dnerf <scene> --test -O --workspace ws

The field is JAX's ``dnerf_config()``: 16 levels x 2 channels, a 2^19
table, whatever ``--grid_levels``/``--grid_featdim`` say. ``--test`` builds
the field from the workspace's ``checkpoints/model_config.json`` when there
is one (JAX builds it from the command line), so it serves the variant and
widths that were trained. Options JAX's ``main_dnerf`` does not pass to its
trainer are named, one line each, when they are set.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

from focnerf_tpu_torch import resolve_device
from focnerf_tpu_torch.config import Options, parse_options

# options main_dnerf does not honour, and why (JAX's build_trainer passes none of them)
IGNORED = {
    "eval_renderer": "views render through render_image_dnerf (the oneshot chunks), as JAX's D-NeRF trainer's do",
    "stochastic_corners": "the D-NeRF encode is exact: its position gradient turns corner draws off, as JAX's "
                          "input_grads=True does",
    "bucket_slabs": "the D-NeRF step keeps --train_slab, as JAX's D-NeRF trainer does",
    "upsample_steps": "the D-NeRF uniform path has no importance samples",
    "tv_weight": "the D-NeRF loss has no TV term",
    "alpha_loss": "the D-NeRF loss has no alpha term",
    "lr_warmup": "JAX's main_dnerf does not pass it",
    "grad_clip": "JAX's main_dnerf does not pass it",
    "grad_level_phases": "JAX's main_dnerf does not pass it",
    "c2f": "JAX's main_dnerf does not pass it",
    "steps_per_dispatch": "the port runs one step per dispatch",
    "eval_interval": "the trainer evaluates every 50 epochs, as JAX's main_dnerf leaves it",
    "eval_save_images": "JAX's main_dnerf does not pass it",
    "mesh_res": "meshes are extracted at 128^3, as JAX's main_dnerf does",
    "color_space": "the D-NeRF step compares sRGB pixels, as JAX's does",
    "grid_levels": "the D-NeRF field has 16 levels, as JAX's dnerf_config()",
    "grid_featdim": "the D-NeRF field has 2 channels a level, as JAX's dnerf_config()",
    "grid_int8": "the port's table gradient is exact",
    "preload": "the port preloads every split to the device",
    "rand_pose": "the D-NeRF trainer has no CLIP rand-pose branch; JAX's main_dnerf does not read it",
}


def warn_ignored(opt: Options) -> None:
    """One line for each option that is set away from its default and that
    main_dnerf does not honour (the stochastic corners also when ``-O``
    sets them)."""
    defaults = Options()
    for name, why in IGNORED.items():
        value = getattr(opt, name)
        if value != getattr(defaults, name) or (name == "eval_renderer" and value != "oneshot"):
            print(f"[main_dnerf] --{name} {value} is ignored: {why}")


def build_trainer(opt: Options, cfg, device, use_checkpoint=None):
    from focnerf_tpu_torch.train.dnerf_trainer import DNeRFTrainer

    return DNeRFTrainer(
        "dnerf", cfg, workspace=opt.workspace, lr=opt.lr, lr_net=opt.lr_net or None, iters=opt.iters,
        num_steps=opt.num_steps, max_ray_batch=opt.max_ray_batch, use_occupancy=opt.cuda_ray,
        dt_gamma=opt.dt_gamma, max_steps=opt.max_steps, train_slab=opt.train_slab, skip_march=opt.skip_march,
        density_thresh=opt.density_thresh, update_extra_interval=opt.update_extra_interval,
        min_near=opt.min_near, use_checkpoint=use_checkpoint or opt.ckpt, ckpt_interval=opt.ckpt_interval,
        seed=opt.seed, time_slots=opt.time_slots, device=device,
    )


def main(argv=None, device=None):
    """CLI entry; ``device`` None means ``cuda`` (raises without CUDA).
    Returns the ``DNeRFTrainer`` (after training, or after ``--test``)."""
    from focnerf_tpu_torch.data.dnerf_provider import DNeRFDataset
    from focnerf_tpu_torch.train.checkpoints import load_model_config

    opt = parse_options(argv)
    device = resolve_device(device)
    warn_ignored(opt)
    os.makedirs(opt.workspace, exist_ok=True)
    cfg = opt.dnerf_config()
    dopt = dataclasses.replace(opt.dataset_options(), host_pipeline=False)  # see IGNORED

    if opt.test:
        saved = load_model_config(os.path.join(opt.workspace, "checkpoints"))
        trainer = build_trainer(opt, saved or cfg, device, use_checkpoint="latest")
        test_ds = DNeRFDataset(dopt, split="test", device=device)
        t0 = time.time()
        trainer.test(test_ds, save_gt=opt.save_gt)
        trainer.log(f"[dnerf] rendered {test_ds.n_views} test views in {time.time() - t0:.1f}s")
        return trainer

    trainer = build_trainer(opt, cfg, device)
    train_ds = DNeRFDataset(dopt, split="train", device=device)
    try:
        val_ds = DNeRFDataset(dopt, split="val", device=device)
    except FileNotFoundError:
        val_ds = None
    steps_per_epoch = max(train_ds.n_views, 1)
    # the REMAINING iters: a --ckpt latest resume starts at its step
    remaining = max(0, opt.iters - trainer.global_step)
    t0 = time.time()
    trainer.train(train_ds, val_ds, max_epochs=int(np.ceil(remaining / steps_per_epoch)),
                  steps_per_epoch=steps_per_epoch)
    trainer.log(f"[dnerf] trained {opt.iters} iters in {time.time() - t0:.1f}s")
    if val_ds is not None and trainer.last_eval_step != trainer.global_step:
        trainer.evaluate(val_ds)  # the cadence eval did not run at the last step
    try:
        for t in ([float(opt.mesh_t)] if opt.mesh_t is not None else [0.0, 1.0]):
            trainer.save_mesh(resolution=128, threshold=opt.density_thresh, t=t)
    except Exception as e:  # mesh export must never kill a training run
        trainer.log(f"[WARN] mesh export failed: {e}")
    return trainer


if __name__ == "__main__":
    main()
