"""FOC-NeRF CLI: train one NeRF per detected object, or render the test split.

Twin of focnerf_tpu/apps/main_nerf.py:

  - training (:50-135), per detected object: the masked train/val splits,
    the obj-feat sidecar (``<workspace>/obj_feats/<obj>.npz``), a
    ``Trainer`` in ``<workspace>_<obj>``, ``train``, a final ``evaluate``
    when the val split exists, the mesh export (``--mesh_res``, an OBJ in
    ``<workspace>_<obj>/meshes``), and ``<workspace>/train_times.txt``;
  - ``--test`` (:138-178): per object with a checkpoint, the test split with
    its object features synthesized from the saved training-view features,
    rendered to ``<workspace>_<obj>/results``.

Usage:
  python -m focnerf_tpu_torch.apps.main_nerf <scene> -O --workspace ws --iters 30000
  python -m focnerf_tpu_torch.apps.main_nerf <scene> -O2 --workspace ws --iters 30000
  python -m focnerf_tpu_torch.apps.main_nerf <scene> --upsample_steps 64 --error_map --workspace ws
  python -m focnerf_tpu_torch.apps.main_nerf <scene> --test -O --workspace ws

``--no-preload`` keeps the train split on the host and draws each batch
with the native threaded loader (data/native_loader.py), as JAX's host
pipeline does; ``-O`` preloads. Without ``-O`` the trainer samples
uniformly (``--num_steps``, plus ``--upsample_steps`` importance samples);
``-O2`` adds the coarse-to-fine stages (``--c2f``) and the alternating
level-subset backward (``--grad_level_phases``) to ``-O``; ``--error_map``,
``--patch_size`` and ``--tv_weight`` work on either path. ``--rand_pose N``
with ``--clip_text`` makes every (N+1)-th step a GT-free CLIP step, which
needs transformers' CLIP weights in the local cache; without them the
trainer says so once and trains on (train/trainer.py). As in JAX, the CLIP
step passes no object feature, so it needs ``--n_chunks 0``.

Training evaluates the val split with ``--eval_renderer`` (default ``iter``,
the iterative worklist renderer; ``iter_dev`` its drain; ``oneshot`` the
chunked slab renderer). ``--test`` renders through the oneshot renderer
with the ladder marcher whatever the flags say, as the JAX test mode does.
"""

from __future__ import annotations

import os
import time

import numpy as np

from focnerf_tpu_torch import resolve_device
from focnerf_tpu_torch.config import Options, parse_options


def detected_objects(sidecar, opt: Options):
    if sidecar is None:
        return ["background"]
    names = [str(n) for n in sidecar["names"]]
    if opt.objects_of_interest:
        names = [n for n in names if n in opt.objects_of_interest or n == "background"]
    return names


def mask_details_for(sidecar, obj: str):
    if sidecar is None:
        return None
    return {
        "masks": sidecar[f"{obj}__masks"],
        "feats": sidecar[f"{obj}__feats"],
        "paths": sidecar.get("paths"),
    }


def trainer_options(opt: Options) -> dict:
    """The training ``Trainer``'s keyword arguments from the options."""
    return dict(
        lr=opt.lr, lr_net=opt.lr_net or None, lr_warmup=opt.lr_warmup,
        alpha_loss=opt.alpha_loss, grad_clip=opt.grad_clip,
        grad_level_phases=opt.grad_level_phases, c2f=opt.c2f, iters=opt.iters,
        num_steps=opt.num_steps, upsample_steps=opt.upsample_steps,
        max_ray_batch=opt.max_ray_batch, use_occupancy=opt.cuda_ray, dt_gamma=opt.dt_gamma,
        max_steps=opt.max_steps, train_slab=opt.train_slab, bucket_slabs=opt.bucket_slabs,
        skip_march=opt.skip_march, density_thresh=opt.density_thresh,
        update_extra_interval=opt.update_extra_interval,
        steps_per_dispatch=opt.steps_per_dispatch, min_near=opt.min_near,
        color_space=opt.color_space, tv_weight=opt.tv_weight, use_checkpoint=opt.ckpt,
        seed=opt.seed, rand_pose=opt.rand_pose, clip_text=opt.clip_text, eval_interval=opt.eval_interval,
        ckpt_interval=opt.ckpt_interval, eval_save_images=opt.eval_save_images,
        eval_renderer=opt.eval_renderer,
    )


def train_one_object(opt: Options, obj: str, sidecar_train, sidecar_val, device):
    from focnerf_tpu_torch.data.feats import save_obj_feats
    from focnerf_tpu_torch.data.provider import NeRFDataset
    from focnerf_tpu_torch.train.trainer import Trainer

    print(f"[main_nerf] training object: {obj}")
    train_ds = NeRFDataset(
        opt.dataset_options(), split="train",
        mask_details=mask_details_for(sidecar_train, obj), detected_object=obj, device=device,
    )
    try:
        val_ds = NeRFDataset(
            opt.dataset_options(), split="val",
            mask_details=mask_details_for(sidecar_val, obj), detected_object=obj, device=device,
        )
    except FileNotFoundError:
        val_ds = None
    if train_ds.obj_feats is not None:  # for composition/editing (ref :256-261)
        save_obj_feats(os.path.join(opt.workspace, "obj_feats", f"{obj}.npz"),
                       train_ds.obj_feats, train_ds.poses)
    trainer = Trainer("ngp", opt.nerf_config(), workspace=f"{opt.workspace}_{obj}", device=device,
                      **trainer_options(opt))
    trainer.check_eval_renderer()  # refuse before training, not after it
    steps_per_epoch = max(train_ds.n_views, 1)
    # train the REMAINING iters: a --ckpt latest resume starts at its step
    remaining = max(0, opt.iters - trainer.global_step)
    t0 = time.time()
    trainer.train(train_ds, val_ds, max_epochs=int(np.ceil(remaining / steps_per_epoch)),
                  steps_per_epoch=steps_per_epoch)
    train_time = time.time() - t0
    train_ds.close()  # the native loader's threads, under --no-preload
    with open(os.path.join(opt.workspace, "train_times.txt"), "a") as f:
        f.write(f"{obj}: {train_time:.2f}s for {opt.iters} iters\n")
    if val_ds is not None and trainer.last_eval_step != trainer.global_step:
        trainer.evaluate(val_ds)
    if opt.mesh_res > 0:
        try:
            trainer.save_mesh(resolution=opt.mesh_res, threshold=opt.density_thresh)
        except Exception as e:  # mesh export must never kill a training run
            trainer.log(f"[WARN] mesh export failed: {e}")
    return trainer


def test_mode(opt: Options, sidecar_test, device):
    from focnerf_tpu_torch.data.feats import calculate_feats, load_obj_feats
    from focnerf_tpu_torch.data.provider import NeRFDataset
    from focnerf_tpu_torch.train.trainer import Trainer

    for obj in detected_objects(sidecar_test, opt):
        ws = f"{opt.workspace}_{obj}"
        if not os.path.isdir(os.path.join(ws, "checkpoints")):
            continue
        test_ds = NeRFDataset(
            opt.dataset_options(), split="test",
            mask_details=mask_details_for(sidecar_test, obj), detected_object=obj,
            device=device,
        )
        # test-view features are synthesized from the saved training-view
        # features by inverse-pose-distance weighting (ref main_nerf.py:288)
        feats_path = os.path.join(opt.workspace, "obj_feats", f"{obj}.npz")
        if os.path.exists(feats_path):
            saved = load_obj_feats(feats_path)
            test_ds.obj_feats = calculate_feats(test_ds.poses, saved["obj_feats"], saved["poses"])
        # like the JAX test mode, eval_renderer and skip_march are not passed:
        # the trainer's defaults (oneshot, ladder marching) render the test split
        trainer = Trainer(
            "ngp", opt.nerf_config(), workspace=ws, use_checkpoint="latest",
            num_steps=opt.num_steps, upsample_steps=opt.upsample_steps,
            max_ray_batch=opt.max_ray_batch, min_near=opt.min_near,
            use_occupancy=opt.cuda_ray,
            dt_gamma=opt.dt_gamma, max_steps=opt.max_steps,
            train_slab=opt.train_slab, density_thresh=opt.density_thresh,
            device=device,
        )
        t0 = time.time()
        trainer.test(test_ds, save_gt=opt.save_gt)
        with open(os.path.join(opt.workspace, "render_times.txt"), "a") as f:
            f.write(f"{obj}: {time.time()-t0:.2f}s for {test_ds.n_views} views\n")


def warn_ignored(opt: Options) -> None:
    """One line for each option the port accepts and ignores, and why."""
    if opt.grid_int8:
        print("[main_nerf] --grid_int8 is ignored: it quantizes the JAX package's TPU one-hot "
              "table backward; the port's scatter is exact, as JAX's is off the TPU")


def main(argv=None, device=None):
    """CLI entry; ``device`` None means ``cuda`` (raises without CUDA).
    Returns the trained objects' ``Trainer``s (none in ``--test`` mode)."""
    opt = parse_options(argv)
    device = resolve_device(device)
    os.makedirs(opt.workspace, exist_ok=True)
    warn_ignored(opt)

    from focnerf_tpu_torch.data.yolo_sidecar import load_sidecar, preprocess_scene

    sidecars = {s: load_sidecar(opt.path, s) for s in ("train", "val", "test")}
    if sidecars["train"] is None:
        print("[main_nerf] no YOLO sidecar found; running preprocessing "
              f"({'disabled' if opt.disable_yolo else 'yolo'} mode)")
        preprocess_scene(opt.path, model_name=opt.yolo_model, disable_yolo=opt.disable_yolo)
        sidecars = {s: load_sidecar(opt.path, s) for s in ("train", "val", "test")}
    if opt.test:
        test_mode(opt, sidecars["test"] or sidecars["train"], device)
        return []
    return [
        train_one_object(opt, obj, sidecars["train"], sidecars["val"], device)
        for obj in detected_objects(sidecars["train"], opt)
    ]


if __name__ == "__main__":
    main()
