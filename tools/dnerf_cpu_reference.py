"""D-NeRF on the CPU at a reduced width, the JAX package beside the port, on
``chip_smoke.py``'s moving-sphere scene with its ``[dnerf]`` flags.

    python tools/dnerf_cpu_reference.py --workspace workspace_dnerf_ref
    python tools/dnerf_cpu_reference.py --package jax --iters 100 --res 96

Writes the scene (``chip_smoke.write_dynamic_scene`` at ``--res``), then for
each package builds main_dnerf's trainer from ``-O --dnerf_variant deform
--time_slots 8`` with the field cut to REDUCED (8 levels, a 2^15 table,
32-wide sigma and color nets, a 4 x 64 deformation net), trains ``--iters``
steps and evaluates the val split. Prints one row a package: val PSNR,
SSIM, seconds. Both run on the CPU; JAX is forced there.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

REDUCED = dict(num_levels=8, log2_hashmap_size=15, hidden_dim=32, hidden_dim_color=32, deform_hidden=64,
               deform_layers=4)


def _argv(scene, ws, iters, num_rays):
    import chip_smoke

    return [scene, "-O", "--dnerf_variant", "deform", "--workspace", ws, "--iters", str(iters), "--time_slots",
            str(chip_smoke.DNERF_SLOTS), "--ckpt", "scratch", "--ckpt_interval", "1000", "--num_rays",
            str(num_rays), "--no-eval_save_images"]


def run_jax(scene, ws, iters, num_rays):
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    from focnerf_tpu.apps.main_dnerf import build_trainer
    from focnerf_tpu.config import parse_options
    from focnerf_tpu.data.dnerf_provider import DNeRFDataset

    opt = parse_options(_argv(scene, ws, iters, num_rays), dnerf=True)
    trainer = build_trainer(opt, dataclasses.replace(opt.dnerf_config(), **REDUCED))
    train_ds = DNeRFDataset(opt.dataset_options(), split="train")
    val_ds = DNeRFDataset(opt.dataset_options(), split="val")
    return _train(trainer, train_ds, val_ds, iters)


def run_torch(scene, ws, iters, num_rays):
    from focnerf_tpu_torch.apps.main_dnerf import build_trainer
    from focnerf_tpu_torch.config import parse_options
    from focnerf_tpu_torch.data.dnerf_provider import DNeRFDataset

    opt = parse_options(_argv(scene, ws, iters, num_rays))
    trainer = build_trainer(opt, dataclasses.replace(opt.dnerf_config(), **REDUCED), "cpu")
    train_ds = DNeRFDataset(opt.dataset_options(), split="train", device="cpu")
    val_ds = DNeRFDataset(opt.dataset_options(), split="val", device="cpu")
    return _train(trainer, train_ds, val_ds, iters)


def _train(trainer, train_ds, val_ds, iters):
    t0 = time.time()
    n = max(train_ds.n_views, 1)
    trainer.train(train_ds, None, max_epochs=math.ceil(iters / n), steps_per_epoch=n)
    train_s = time.time() - t0
    res = trainer.evaluate(val_ds, save_images=False)
    return {"psnr": float(res["PSNR"]), "ssim": float(res["SSIM"]), "steps": trainer.global_step,
            "train_s": round(train_s, 1), "eval_s": round(time.time() - t0 - train_s, 1)}


def main(argv=None):
    import chip_smoke

    p = argparse.ArgumentParser()
    p.add_argument("--workspace", default="workspace_dnerf_ref")
    p.add_argument("--package", default="jax,torch")
    p.add_argument("--iters", type=int, default=chip_smoke.DNERF_ITERS)
    p.add_argument("--res", type=int, default=chip_smoke.DNERF_RES)
    p.add_argument("--num_rays", type=int, default=4096)
    args = p.parse_args(argv)
    chip_smoke.DNERF_RES = args.res
    scene = os.path.join(args.workspace, f"dnerf_scene_{args.res}")
    if not os.path.exists(os.path.join(scene, "transforms_test.json")):
        chip_smoke.write_dynamic_scene(scene, 0.33)
    for pkg in args.package.split(","):
        ws = os.path.join(args.workspace, f"ws_{pkg}")
        shutil.rmtree(ws, ignore_errors=True)
        row = {"jax": run_jax, "torch": run_torch}[pkg](scene, ws, args.iters, args.num_rays)
        print(f"[dnerf-cpu] {pkg}: deform -O at {REDUCED}, {row['steps']} steps of {args.num_rays} rays on the "
              f"moving sphere at {args.res}x{args.res}: val PSNR {row['psnr']:.3f} dB, SSIM {row['ssim']:.4f}; "
              f"train {row['train_s']} s, eval {row['eval_s']} s (CPU)", flush=True)


if __name__ == "__main__":
    main()
