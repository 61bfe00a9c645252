"""Voxel-family training CLI: dense, VM, low-rank dynamic and K-planes fields.

Twin of focnerf_tpu/apps/main_voxel.py. Trains a voxel field directly
through the differentiable shear-warp renderer (``train/voxel*.py``) and
writes the workspace's artifacts in JAX's formats, so either package (and
``combined``/``editable --baked``) reads them:

  python -m focnerf_tpu_torch.apps.main_voxel <scene> --workspace ws \\
      --bake_res 128 --iters 500 [--bake_sh 2] [--voxel_c2f 3] [--bake_quantize]
      [--voxel_vm K | --voxel_dynamic | --voxel_kplanes K] [--voxel_supervise screen]

  - dense and ``--voxel_vm K``: ``baked_<res>_sh<deg>.npz`` (uint8 with
    ``--bake_quantize``, then the quantization gate's ``bake_quality.json``),
    ``mesh.obj``; VM also ``vmfield_<res>_r<K>.npz``, from which a later run
    warm-starts;
  - ``--voxel_dynamic`` / ``--voxel_kplanes K`` (the D-NeRF provider's
    per-frame times): ``dynvoxel_*.npz`` / ``kplanes_*.npz`` and
    ``mesh_t<t>.obj`` at ``--mesh_t`` or at t = 0 and 1;
  - every family: ``[<tag>] ... train PSNR x dB, y rays/s`` and ``val PSNR:
    x dB over n views`` on stdout and a line in ``<workspace>/log.txt``.

``--voxel_sp`` trains the dense family slice-parallel over every rank
(``parallel/voxel_sp.py``; ``--voxel_c2f S`` stages it), ``--voxel_sp
--voxel_dp N`` on a hybrid (N data rows x ranks/N slice shards) mesh, and
``--voxel_sp --voxel_kplanes K [--voxel_c2f S]`` the K-planes family with
its collapse cut over every rank (``parallel/kplanes_sp.py``; the planes
replicated). One process per device, launched by torchrun (without it: one
rank):

  torchrun --nproc_per_node 2 -m focnerf_tpu_torch.apps.main_voxel <scene> \
      --workspace ws --bake_res 256 --voxel_sp [--voxel_dp 2 | --voxel_kplanes 8]

Rank 0 alone writes the volume or field, the meshes and the log; every rank
returns the trained volume or field. As in JAX: ``--voxel_dp`` without
``--voxel_sp`` is ignored (one device, and one line says so); ``--voxel_sp
--voxel_kplanes`` refuses ``--voxel_dp`` and a ``--bake_res`` that does not
divide over the ranks; ``--voxel_sp --voxel_vm`` is refused (the VM step,
``parallel/vm_sp.py``, is a library step).
``--steps_per_dispatch K`` runs JAX's update sequence in chunks of K steps
(``train/voxel.py::_fit_field_loop``; on the card each shear-warp
variant's step is a CUDA graph replayed in schedule order); as in JAX,
``--voxel_sp`` does not fuse.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from focnerf_tpu_torch import resolve_device
from focnerf_tpu_torch.config import parse_options


def _save_volume_mesh(vol, path, density_thresh, tag):
    """Mesh the trained field's sigma at --density_thresh, or at half the
    peak sigma when the threshold would select nothing."""
    try:
        from focnerf_tpu_torch.utils.mesh_extract import mesh_from_volume, save_obj

        peak = float(vol.rgba[..., -1].max())
        thr = min(density_thresh, 0.5 * peak) if peak > 0 else density_thresh
        verts, faces = mesh_from_volume(vol, thr)
        save_obj(path, verts, faces)
        print(f"[{tag}] mesh: {len(verts)} verts / {len(faces)} faces -> {path}")
    except Exception as e:  # mesh export must never kill a training run
        print(f"[{tag}] WARN: mesh export failed: {type(e).__name__}: {e}")


def _rgb_on_white(ds) -> torch.Tensor:
    """The split's images [V, H, W, 3] fp32, RGBA composited onto white."""
    imgs = ds.images.float().reshape(ds.n_views, ds.H, ds.W, -1)
    if imgs.shape[-1] == 4:
        a = imgs[..., 3:]
        imgs = imgs[..., :3] * a + 1.0 * (1.0 - a)
    return imgs


def _val_psnr(val_ds, volume_at):
    """Mean PSNR over the val views of render_baked(volume_at(v))."""
    from focnerf_tpu_torch.render.baked import render_baked

    gts = _rgb_on_white(val_ds)
    psnrs = []
    for v in range(val_ds.n_views):
        img, _, _ = render_baked(volume_at(v), val_ds.poses[v], val_ds.intrinsics, val_ds.H, val_ds.W,
                                 bg_color=1.0)
        mse = float(torch.mean((img - gts[v]) ** 2))
        psnrs.append(-10.0 * np.log10(max(mse, 1e-10)))
    return float(np.mean(psnrs)), len(psnrs)


def _refuse(opt):
    n_fam = int(opt.voxel_dynamic) + int(opt.voxel_vm > 0) + int(opt.voxel_kplanes > 0)
    if n_fam > 1:
        raise ValueError("pick ONE family: --voxel_dynamic | --voxel_vm K | --voxel_kplanes K "
                         "(or none for the dense field)")
    if opt.voxel_sp:
        if opt.voxel_dynamic or opt.voxel_vm > 0:
            raise ValueError("--voxel_sp shards the dense and K-planes families; drop --voxel_vm/--voxel_dynamic "
                             "(their factorized params replicate: use the DP step)")
        if opt.voxel_supervise != "intermediate":
            raise ValueError("--voxel_sp trains with intermediate-plane supervision only (parallel/voxel_sp.py, "
                             "parallel/kplanes_sp.py)")
        if opt.voxel_kplanes > 0 and opt.voxel_dp > 0:
            raise ValueError("--voxel_dp is the dense family's hybrid mesh; --voxel_sp --voxel_kplanes shards the "
                             "collapse over every rank — drop --voxel_dp")
        if opt.voxel_dp > 0 and opt.voxel_c2f > 1:
            raise ValueError("--voxel_dp does not stage yet; drop --voxel_c2f or --voxel_dp")
    if opt.voxel_supervise != "intermediate" and n_fam:
        raise ValueError("--voxel_supervise is only implemented for the dense family; the VM and "
                         "dynamic families train with intermediate-plane supervision")


def _train_dynamic(opt, train_ds, val_ds, imgs):
    """--voxel_dynamic / --voxel_kplanes (with --voxel_sp: collapse-sharded
    over every rank, rank 0 alone writing): fit, save the field, the meshes
    at --mesh_t (or t = 0 and 1), the val PSNR at each view's time."""
    from focnerf_tpu_torch.parallel.distributed import is_main_process

    log_every = max(opt.iters // 10, 1)
    t0 = time.time()
    if opt.voxel_kplanes > 0:
        from focnerf_tpu_torch.train.voxel_kplanes import (
            fit_kplanes,
            fit_kplanes_c2f,
            kplanes_field_to_volume as to_volume,
            save_kplanes_field as save_field,
        )

        tag, rank = "kplanes", opt.voxel_kplanes
        kw = dict(seed=opt.seed, resolution=opt.bake_res, rank=rank, time_res=opt.voxel_time_slots,
                  bound=opt.bound, sh_degree=opt.bake_sh, iters=opt.iters, bg_color=1.0,
                  time_smooth_weight=opt.voxel_time_smooth, log_every=log_every, device=train_ds.device)
        args = (train_ds.poses, imgs, train_ds.times, train_ds.intrinsics)
        if opt.voxel_sp:  # as in JAX, SP does not fuse
            from focnerf_tpu_torch.parallel.kplanes_sp import fit_kplanes_sp, fit_kplanes_sp_c2f

            if opt.voxel_c2f > 1:
                field, info = fit_kplanes_sp_c2f(*args, stages=opt.voxel_c2f, **kw)
            else:
                field, info = fit_kplanes_sp(*args, **kw)
            if is_main_process():
                print(f"[kplanes] SP over {info['n_devices']} devices")
        elif opt.voxel_c2f > 1:
            field, info = fit_kplanes_c2f(*args, stages=opt.voxel_c2f, steps_per_dispatch=opt.steps_per_dispatch,
                                          **kw)
        else:
            field, info = fit_kplanes(*args, steps_per_dispatch=opt.steps_per_dispatch, **kw)
    else:
        from focnerf_tpu_torch.train.voxel_dynamic import (
            dyn_field_to_volume as to_volume,
            fit_dyn_voxels,
            save_dyn_field as save_field,
        )

        tag, rank = "dynvoxel", opt.voxel_rank
        field, info = fit_dyn_voxels(
            train_ds.poses, imgs, train_ds.times, train_ds.intrinsics, resolution=opt.bake_res, rank=rank,
            time_slots=opt.voxel_time_slots, bound=opt.bound, sh_degree=opt.bake_sh, iters=opt.iters,
            bg_color=1.0, time_smooth_weight=opt.voxel_time_smooth, seed=opt.seed, log_every=log_every,
            steps_per_dispatch=opt.steps_per_dispatch, device=train_ds.device,
        )
    if not is_main_process():
        return field, info
    cache = os.path.join(opt.workspace, f"{tag}_{opt.bake_res}_sh{opt.bake_sh}.npz")
    save_field(cache, field, opt.bound, opt.bake_sh)
    print(f"[{tag}] {opt.iters} iters in {time.time() - t0:.1f}s — "
          f"train PSNR {info['psnr']:.2f} dB, {info['rays_per_sec']:.0f} rays/s")
    print(f"[{tag}] saved {cache}")
    ts = [float(opt.mesh_t)] if opt.mesh_t is not None else [0.0, 1.0]
    for t in ts:
        _save_volume_mesh(to_volume(field, t, opt.bound, opt.bake_sh),
                          os.path.join(opt.workspace, f"mesh_t{t:.2f}.obj"), opt.density_thresh, tag=tag)
    if val_ds is not None and val_ds.images is not None:
        psnr, n = _val_psnr(val_ds, lambda v: to_volume(field, float(val_ds.times[v]), opt.bound, opt.bake_sh))
        print(f"[{tag}] val PSNR: {psnr:.2f} dB over {n} views")
        info["val_psnr"] = psnr
        with open(os.path.join(opt.workspace, "log.txt"), "a") as f:
            f.write(f"{tag} res={opt.bake_res} rank={rank} iters={opt.iters} val_psnr={psnr:.3f}\n")
    return field, info


def _train_sp(opt, train_ds, imgs):
    """--voxel_sp [--voxel_c2f S | --voxel_dp N]: the dense fit over every
    rank of the default group (the caller has joined it)."""
    import torch.distributed as dist

    from focnerf_tpu_torch.parallel import voxel_sp

    n_dev = dist.get_world_size()
    if opt.voxel_dp > 0 and n_dev % opt.voxel_dp:
        raise ValueError(f"--voxel_dp {opt.voxel_dp} must divide the {n_dev} ranks")
    n_slice = n_dev // opt.voxel_dp if opt.voxel_dp > 0 else n_dev
    if opt.bake_res % n_slice:
        raise ValueError(f"--bake_res {opt.bake_res} must divide evenly over the {n_slice} slice shards")
    args = (train_ds.poses, imgs, train_ds.intrinsics)
    kw = dict(seed=opt.seed, resolution=opt.bake_res, bound=opt.bound, sh_degree=opt.bake_sh, iters=opt.iters,
              bg_color=1.0, log_every=max(opt.iters // 10, 1), device=train_ds.device)
    if opt.voxel_dp > 0:
        vol, info = voxel_sp.fit_voxels_dp_sp(*args, dp=opt.voxel_dp, **kw)
        if dist.get_rank() == 0:
            print(f"[dpspvoxel] trained on a {info['mesh']['data']}x{info['mesh']['slice']} (data x slice) mesh")
    elif opt.voxel_c2f > 1:
        vol, info = voxel_sp.fit_voxels_sp_c2f(*args, stages=opt.voxel_c2f, **kw)
    else:
        vol, info = voxel_sp.fit_voxels_sp(*args, **kw)
        if dist.get_rank() == 0:
            print(f"[spvoxel] trained sharded over {info['n_devices']} devices")
    return vol, info


def _train_static(opt, train_ds, imgs):
    """Dense (optionally c2f or screen-supervised) or --voxel_vm: fit and
    return (volume, info); VM saves (and warm-starts from) its factors."""
    log_every = max(opt.iters // 10, 1)
    args = (train_ds.poses, imgs, train_ds.intrinsics)
    if opt.voxel_vm > 0:
        from focnerf_tpu_torch.train.voxel_vm import fit_vm_c2f, fit_vm_voxels, load_vm_field, save_vm_field

        vm_path = os.path.join(opt.workspace, f"vmfield_{opt.bake_res}_r{opt.voxel_vm}.npz")
        kw = dict(seed=opt.seed, resolution=opt.bake_res, rank=opt.voxel_vm, bound=opt.bound,
                  sh_degree=opt.bake_sh, iters=opt.iters, bg_color=1.0, log_every=log_every,
                  steps_per_dispatch=opt.steps_per_dispatch, device=train_ds.device)
        if os.path.exists(vm_path):  # warm start (--ckpt latest semantics)
            prev, prev_bound, prev_sh = load_vm_field(vm_path, device=train_ds.device)
            if prev_sh != opt.bake_sh or abs(prev_bound - opt.bound) > 1e-6:
                raise ValueError(
                    f"{vm_path} was trained with sh_degree={prev_sh} bound={prev_bound}; requested "
                    f"--bake_sh {opt.bake_sh} --bound {opt.bound}. Delete the file or match the flags "
                    "to warm-start.")
            print(f"[vmvoxel] resuming factors from {vm_path}")
            vol, info = fit_vm_voxels(*args, init_field=prev, **kw)
        elif opt.voxel_c2f > 1:
            vol, info = fit_vm_c2f(*args, stages=opt.voxel_c2f, **kw)
        else:
            vol, info = fit_vm_voxels(*args, **kw)
        save_vm_field(vm_path, info["field"], opt.bound, opt.bake_sh)
        return vol, info

    from focnerf_tpu_torch.train.voxel import fit_voxels, fit_voxels_c2f

    kw = dict(seed=opt.seed, bound=opt.bound, sh_degree=opt.bake_sh, iters=opt.iters, bg_color=1.0,
              density_scale=1.0, log_every=log_every, supervise=opt.voxel_supervise,
              steps_per_dispatch=opt.steps_per_dispatch, resolution=opt.bake_res, device=train_ds.device)
    if opt.voxel_c2f > 1:
        return fit_voxels_c2f(*args, stages=opt.voxel_c2f, **kw)
    return fit_voxels(*args, **kw)


def main(argv=None, device=None):
    """Train the chosen family on ``device`` (None: ``cuda``). Returns
    (volume or field, info): info has the fit's "psnr", "rays_per_sec",
    "seconds", "step_mse" and, with a val split, "val_psnr". With
    ``--voxel_sp`` it joins (or creates) the default process group and every
    rank returns the trained volume; only rank 0 writes and evaluates."""

    opt = parse_options(argv)
    _refuse(opt)
    device = resolve_device(device)
    if opt.voxel_dp > 0 and not opt.voxel_sp:
        print(f"[voxel] --voxel_dp {opt.voxel_dp} is ignored without --voxel_sp: training on one device")
    if not opt.voxel_sp:
        return _main(opt, device)
    import torch.distributed as dist

    from focnerf_tpu_torch.parallel.distributed import initialize, shutdown

    owns_group = not dist.is_initialized()  # a torchrun launch, or one rank
    world = initialize(device=device)["num_processes"]
    try:
        if opt.voxel_kplanes > 0 and opt.bake_res % world:  # before any data loads
            raise ValueError(f"--bake_res {opt.bake_res} must divide evenly over the {world} ranks for collapse "
                             "sharding")
        return _main(opt, device)
    finally:
        if owns_group:
            shutdown()


def _main(opt, device):
    from focnerf_tpu_torch.data.provider import DatasetOptions, NeRFDataset
    from focnerf_tpu_torch.parallel.distributed import is_main_process
    from focnerf_tpu_torch.render.baked import load_volume, save_volume

    os.makedirs(opt.workspace, exist_ok=True)

    ds_opt = DatasetOptions(path=opt.path, scale=opt.scale, offset=tuple(opt.offset), downscale=opt.downscale,
                            num_rays=opt.num_rays)
    dynamic = opt.voxel_dynamic or opt.voxel_kplanes > 0
    if dynamic:
        from focnerf_tpu_torch.data.dnerf_provider import DNeRFDataset as Dataset
    else:
        Dataset = NeRFDataset
    train_ds = Dataset(ds_opt, split="train", device=device)
    try:
        val_ds = Dataset(ds_opt, split="val", device=device)
    except FileNotFoundError:
        val_ds = None
    imgs = _rgb_on_white(train_ds)

    if dynamic:
        return _train_dynamic(opt, train_ds, val_ds, imgs)

    t0 = time.time()
    vol, info = _train_sp(opt, train_ds, imgs) if opt.voxel_sp else _train_static(opt, train_ds, imgs)
    if not is_main_process():
        return vol, info
    print(f"[voxel] {opt.iters} iters in {time.time() - t0:.1f}s — "
          f"train PSNR {info['psnr']:.2f} dB, {info['rays_per_sec']:.0f} rays/s")

    # the collapsed volume is the product-facing artifact: --baked reads it
    cache = os.path.join(opt.workspace, f"baked_{opt.bake_res}_sh{opt.bake_sh}.npz")
    save_volume(cache, vol, quantize=opt.bake_quantize)
    print(f"[voxel] saved {cache}" + (" (uint8)" if opt.bake_quantize else ""))
    if opt.bake_quantize and opt.bake_gate:
        # the trained field is the volume: quantization is the only bake loss
        from focnerf_tpu_torch.render.bake_gate import volume_quantization_report

        rep = volume_quantization_report(
            vol, load_volume(cache, device=device), train_ds.poses, train_ds.intrinsics, train_ds.H, train_ds.W,
            out_path=os.path.join(opt.workspace, "bake_quality.json"),
        )
        info["quantization_report"] = rep
        print(f"[bake-gate] quantized-vs-float {rep['psnr_quantized_vs_float_mean']} dB mean")
    _save_volume_mesh(vol, os.path.join(opt.workspace, "mesh.obj"), opt.density_thresh, tag="voxel")

    if val_ds is not None and val_ds.images is not None:
        psnr, n = _val_psnr(val_ds, lambda v: vol)
        print(f"[voxel] val PSNR: {psnr:.2f} dB over {n} views")
        info["val_psnr"] = psnr
        with open(os.path.join(opt.workspace, "log.txt"), "a") as f:
            f.write(f"voxel res={opt.bake_res} sh={opt.bake_sh} iters={opt.iters} val_psnr={psnr:.3f}\n")
    return vol, info


if __name__ == "__main__":
    main()
