"""Scene composition CLI: fuse N per-object NeRFs along shared rays.

Twin of focnerf_tpu/apps/combined.py (the reference's COMBINED.py). Every
object's params load once and stay on the device; each val view is composed
by ``render/compose.py`` (a running max-density fusion, so the object count
costs no memory) and, when every object trained with an occupancy grid and
no object is rotated, marched on the union of their bitfields.

Outputs, as the JAX package writes them (COMBINED.py:403-423, 636-665):
composited renders on white and black backgrounds under ``rgbs_w/``,
``depth_w/``, ``rgbs_b/``, ``depth_b/`` and ``ground_truth_{w,b}/``,
per-view time and PSNR lines and a PSNR/SSIM/LPIPS summary block in
``<workspace>/log.txt``, and with ``write_video`` ``composite.mp4`` (or its
PNG frames where no mp4 writer exists).

With ``--baked`` (JAX evaluate_composition :203-288) each checkpointed
object is baked once at ``--bake_res`` (``--bake_sh``), its bake-vs-exact
PSNR written to ``<ckpt_dir>/<ws>_<obj>/bake_quality.json`` (``--bake_gate``,
on by default), rotated and shifted by its edit, merged by max density and,
with ``--bake_quantize``, served uint8-resident; every view then renders by
shear-warp (render/baked.py). A voxel-trained workspace
(``<ws>_<obj>/baked_<res>_sh<deg>.npz``, as JAX main_voxel writes it) joins
the merge as its volume; it has no network, so it composes only with
``--baked``.

Usage:
  python -m focnerf_tpu_torch.apps.combined <scene> --ckpt_dir <dir with ws_<obj>> \\
      --objects_of_interest book cup --workspace combined_ws
"""

from __future__ import annotations

import os
import time
from typing import Dict, List

import numpy as np
import torch

from focnerf_tpu_torch import resolve_device
from focnerf_tpu_torch.config import Options, parse_options


def _baked_cache_name(opt: Options) -> str:
    return f"baked_{opt.bake_res}_sh{opt.bake_sh}.npz"


def _object_kind(ws_dir: str, opt: Options) -> str:
    """"ckpt" (a network checkpoint with its model_config.json), "volume"
    (a voxel-trained object, main_voxel), or "" (not an object workspace)."""
    ckpt = os.path.join(ws_dir, "checkpoints")
    if os.path.isdir(ckpt) and os.path.exists(os.path.join(ckpt, "model_config.json")):
        return "ckpt"
    if os.path.exists(os.path.join(ws_dir, _baked_cache_name(opt))):
        return "volume"
    return ""


def discover_objects(opt: Options) -> List[str]:
    """The object names of the ``<ws>_<obj>`` workspaces under
    ``--ckpt_dir`` (filtered by ``--objects_of_interest``), sorted."""
    root = opt.ckpt_dir or "."
    objs = []
    for name in sorted(os.listdir(root)):
        if "_" not in name:
            continue
        obj = name.rsplit("_", 1)[-1]
        if _object_kind(os.path.join(root, name), opt):
            if not opt.objects_of_interest or obj in opt.objects_of_interest:
                objs.append(obj)
    return objs


def _ws_prefix(opt: Options) -> str:
    # object workspaces are "<workspace>_<obj>" under ckpt_dir (main_nerf flow)
    root = opt.ckpt_dir or "."
    candidates = [
        n.rsplit("_", 1)[0]
        for n in os.listdir(root)
        if "_" in n and _object_kind(os.path.join(root, n), opt)
    ]
    return candidates[0] if candidates else "workspace"


def load_composition(opt: Options, feats_mode: str = "avg", test_poses=None, device=None):
    """Every object's params, loaded once onto ``device``, and its features.

    Returns (objs, cfg, stacked params, obj_feats, stacked occupancy
    bitfields [K, CAS, H^3] or None, {obj: baked volume path}). ``feats_mode``
    "avg" gives obj_feats [K, F] (calculate_avg_feats_inference,
    COMBINED.py:701); "pose" gives [T, K, F] for ``test_poses`` [T, 4, 4]
    (calculate_feats2_inference, editable.py:781). The bitfields are None
    when an object trained without a grid (then sampling is uniform).
    """
    from focnerf_tpu_torch.ops.occupancy import occupancy_bitfield
    from focnerf_tpu_torch.render.compose import stack_object_params
    from focnerf_tpu_torch.train.checkpoints import (
        gather_obj_feats,
        load_object_occupancy,
        load_object_params,
    )

    device = resolve_device(device)
    objs = discover_objects(opt)
    if not objs:
        raise SystemExit(f"no object checkpoints found under {opt.ckpt_dir!r}")
    root = opt.ckpt_dir or "."
    prefix = _ws_prefix(opt)
    cfg = None
    params_list, occ_list = [], []
    # voxel-trained objects carry no network: they compose only with --baked
    vol_paths: Dict[str, str] = {}
    for obj in objs:
        ws_dir = os.path.join(root, f"{prefix}_{obj}")
        if _object_kind(ws_dir, opt) == "volume":
            vol_paths[obj] = os.path.join(ws_dir, _baked_cache_name(opt))
            print(f"[combined] {obj}: voxel volume {vol_paths[obj]}")
            continue
        ckpt_dir = os.path.join(ws_dir, "checkpoints")
        params, cfg = load_object_params(ckpt_dir, cfg or opt.nerf_config(), device=device)
        params_list.append(params)
        occ_list.append(load_object_occupancy(ckpt_dir, cfg, device=device))
        print(f"[combined] loaded {obj}")
    if cfg is None:
        cfg = opt.nerf_config()
    stacked = stack_object_params(params_list) if params_list else None
    stacked_occ = None
    if params_list and all(o is not None for o in occ_list):
        stacked_occ = torch.stack([occupancy_bitfield(o, opt.density_thresh) for o in occ_list])

    obj_feats = None
    if cfg.use_objfeat and params_list:
        feat_paths = gather_obj_feats(root)
        found = {os.path.splitext(os.path.basename(p))[0] for p in feat_paths}
        for obj in objs:
            if obj not in found:
                print(f"[combined] {obj}: no {os.path.join(root, 'obj_feats', obj + '.npz')}; "
                      "composing it with zero object features")
        obj_feats = composition_feats(objs, feat_paths, cfg.yolo_feats_dim, feats_mode=feats_mode,
                                      test_poses=test_poses, device=device)
    return objs, cfg, stacked, obj_feats, stacked_occ, vol_paths


def composition_feats(
    objs: List[str],
    feat_paths: List[str],
    feat_dim: int,
    feats_mode: str = "avg",
    test_poses=None,
    device="cpu",
) -> torch.Tensor:
    """Per-object conditioning features: "avg" -> [K, F], "pose" -> [T, K, F];
    zeros for an object without a sidecar."""
    from focnerf_tpu_torch.data.feats import (
        calculate_avg_feats_inference,
        calculate_feats2_inference,
    )

    zeros = np.zeros(feat_dim, np.float32)
    if feats_mode == "pose":
        if test_poses is None:
            raise ValueError("feats_mode='pose' requires test_poses [T, 4, 4]")
        by_obj = calculate_feats2_inference(np.asarray(test_poses), feat_paths)
        T = len(test_poses)
        feats = np.stack([by_obj.get(o, np.tile(zeros, (T, 1))) for o in objs], axis=1)
    elif feats_mode == "avg":
        by_obj = calculate_avg_feats_inference(feat_paths)
        feats = np.stack([by_obj.get(o, zeros) for o in objs])
    else:
        raise ValueError(f"unknown feats_mode {feats_mode!r}")
    return torch.from_numpy(feats.astype(np.float32)).to(device)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def bake_composition(opt: Options, objs, cfg, stacked, obj_feats, stacked_occ, vol_paths, dataset,
                     offsets, rotations, log):
    """The composed scene as one baked volume (JAX evaluate_composition
    :203-288): voxel-trained objects load their volume (its sigma divided by
    ``cfg.density_scale``, which the render multiplies back), checkpointed
    ones bake (and pass the gate); each is rotated, then shifted by -offset;
    the volumes merge by max density and, with ``--bake_quantize``, quantize
    to a uint8-resident volume. ``log`` receives one line per stage."""
    from focnerf_tpu_torch.render.bake_gate import bake_quality_report
    from focnerf_tpu_torch.render.baked import (
        BakedVolume,
        bake_field,
        load_volume,
        merge_volumes,
        quantize_volume,
        rotate_volume,
        shift_volume,
    )

    device = dataset.device
    # pose-mode features ([T, K, F]) bake with their mean over the views
    avg_feats = obj_feats if (obj_feats is None or obj_feats.dim() == 2) else obj_feats.mean(0)
    t_all = time.time()
    vols = []
    ki = 0  # position in the checkpointed objects' stack
    for k, obj in enumerate(objs):
        t0 = time.time()
        if obj in vol_paths:
            vol = load_volume(vol_paths[obj], device=device)
            if vol.sh_deg != opt.bake_sh or vol.rgba.shape[0] != opt.bake_res:
                raise SystemExit(
                    f"{vol_paths[obj]} is {vol.rgba.shape[0]}^3/sh{vol.sh_deg} but the composition "
                    f"is {opt.bake_res}^3/sh{opt.bake_sh} — retrain or match --bake_res/--bake_sh"
                )
            if cfg.density_scale != 1.0:
                # voxel fields train at density_scale 1; the composed render
                # multiplies by cfg.density_scale
                rgba = vol.rgba.clone()
                rgba[..., -1] /= cfg.density_scale
                vol = BakedVolume(rgba=rgba, bound=vol.bound, sh_deg=vol.sh_deg)
            what = "loaded"
        else:
            pk = stacked[ki]
            feats_k = None if avg_feats is None else avg_feats[k]
            occ_k = None if stacked_occ is None else stacked_occ[ki]
            vol = bake_field(pk, cfg, resolution=opt.bake_res, obj_feat=feats_k, occ_bits=occ_k,
                             sh_degree=opt.bake_sh)
            _sync(device)
            what = f"baked in {time.time() - t0:.2f} s"
            if opt.bake_gate:
                t1 = time.time()
                gate_path = os.path.join(opt.ckpt_dir or ".", f"{_ws_prefix(opt)}_{obj}",
                                         "bake_quality.json")
                rep = bake_quality_report(
                    pk, cfg, vol, dataset.poses, dataset.intrinsics, dataset.H, dataset.W,
                    obj_feat=feats_k, occ_bits=occ_k, num_steps=min(opt.num_steps, 256),
                    out_path=gate_path,
                )
                print(f"[bake-gate] {obj}: baked-vs-exact {rep['psnr_baked_vs_exact_mean']} dB mean / "
                      f"{rep['psnr_baked_vs_exact_min']} dB min -> {gate_path}")
                what += f", gate {time.time() - t1:.2f} s"
            ki += 1
        if rotations is not None and np.any(np.asarray(rotations[k])):
            # about the world origin, as JAX; then the translation
            for ax_i, dg in enumerate(np.asarray(rotations[k])):
                if float(dg):
                    vol = rotate_volume(vol, ax_i, float(dg))
        if offsets is not None:
            # compose offsets query the field at x + off: the object sits at -off
            vol = shift_volume(vol, -np.asarray(offsets[k]))
        _sync(device)
        log(f"[baked] {obj}: {what}; {time.time() - t0:.2f} s with its edit")
        vols.append(vol)
    t0 = time.time()
    merged = merge_volumes(vols)
    _sync(device)
    t_merge = time.time() - t0
    if opt.bake_quantize:
        # serve uint8-resident: dequantized inside the compositing fold
        t0 = time.time()
        merged = quantize_volume(merged)
        _sync(device)
        log(f"[baked] merge {t_merge:.2f} s, quantization {time.time() - t0:.2f} s")
    else:
        log(f"[baked] merge {t_merge:.2f} s")
    log(f"[baked] {len(objs)} objects baked+merged at {opt.bake_res}^3 in {time.time() - t_all:.1f}s")
    return merged


def _png(path: str, img) -> None:
    from focnerf_tpu_torch.data.png import write_image

    write_image(path, (np.asarray(img) * 255).astype(np.uint8))


def evaluate_composition(
    opt: Options, offsets=None, write_video: bool = False,
    feats_mode: str = "avg", rotations=None, device=None,
):
    """Compose every val view; writes the renders, ``log.txt`` and, with
    ``write_video``, the video. Returns the black-background frames (uint8)."""
    from focnerf_tpu_torch.data.provider import NeRFDataset
    from focnerf_tpu_torch.render.compose import (
        compose_image,
        rotation_matrices,
        union_occupancy_bits,
    )
    from focnerf_tpu_torch.train.meters import LPIPSMeter, PSNRMeter, SSIMMeter

    from focnerf_tpu_torch.render.baked import render_baked

    device = resolve_device(device)
    dataset = NeRFDataset(opt.dataset_options(), split="val", device=device)
    objs, cfg, stacked, obj_feats, stacked_occ, vol_paths = load_composition(
        opt, feats_mode=feats_mode, test_poses=dataset.poses, device=device
    )
    if vol_paths and not opt.baked:
        raise SystemExit(
            f"voxel-trained objects {sorted(vol_paths)} have no network to "
            "march per sample — compose them with --baked"
        )
    ws = opt.workspace
    for sub in ("rgbs_w", "depth_w", "rgbs_b", "depth_b", "ground_truth_w", "ground_truth_b"):
        os.makedirs(os.path.join(ws, sub), exist_ok=True)
    log_path = os.path.join(ws, "log.txt")

    def log(line: str) -> None:
        print(line)
        with open(log_path, "a") as f:
            f.write(line + "\n")

    baked_vol = None
    if opt.baked:
        # bake once, merge by max density, render every view by shear-warp
        baked_vol = bake_composition(opt, objs, cfg, stacked, obj_feats, stacked_occ, vol_paths, dataset,
                                     offsets, rotations, log)

    rot_mats = None
    if rotations is not None and np.any(np.asarray(rotations)):
        rot_mats = rotation_matrices(rotations, device=device)
    # march on the union of the objects' occupancies (per-sample path only)
    occ_kwargs = {}
    if rot_mats is not None and stacked_occ is not None and baked_vol is None:
        print(
            "[combined] rotation edit active: the union occupancy bitfield "
            "ignores rotation — using uniform sampling for this run"
        )
        stacked_occ = None
    if stacked_occ is not None and baked_vol is None:
        occ_kwargs = dict(
            occ_bits=union_occupancy_bits(stacked_occ, offsets, cfg.bound),
            dt_gamma=opt.dt_gamma,
            max_steps=opt.max_steps,
            slab=max(opt.train_slab, 64),
        )

    aabb = None if opt.bound_inf is None else torch.tensor(opt.bound_inf, dtype=torch.float32)

    meters = {
        "w": (PSNRMeter(), SSIMMeter(), LPIPSMeter()),
        "b": (PSNRMeter(), SSIMMeter(), LPIPSMeter()),
    }
    frames = []
    for v in range(dataset.n_views):
        view = dataset.eval_view(v)
        # pose mode synthesizes distinct features per test view ([T, K, F])
        feats_v = obj_feats if (obj_feats is None or obj_feats.dim() == 2) else obj_feats[v]
        t0 = time.time()
        if baked_vol is not None:
            img_p, depth, alpha_b = render_baked(
                baked_vol, view["pose"], dataset.intrinsics, dataset.H, dataset.W,
                bg_color=0.0, density_scale=cfg.density_scale,
            )
            rgba = torch.cat([img_p, alpha_b[..., None]], -1)
        else:
            rgba, depth = compose_image(
                stacked, cfg, view["pose"], dataset.intrinsics, dataset.H, dataset.W,
                feats_v, offsets, rot_mats, num_steps=opt.num_steps,
                max_ray_batch=opt.max_ray_batch, bg_color=0.0, aabb=aabb,
                min_near=opt.min_near, **occ_kwargs,
            )
        rgb, alpha = rgba[..., :3], rgba[..., 3:]
        img_w = torch.clamp(rgb + (1 - alpha) * 1.0, 0, 1)
        img_b = torch.clamp(rgb, 0, 1)
        depth_img = depth / torch.clamp(depth.max(), min=1e-6)
        host_w, host_b, host_depth = (t.cpu().numpy() for t in (img_w, img_b, depth_img))
        dt = time.time() - t0

        _png(os.path.join(ws, "rgbs_w", f"{v:04d}.png"), host_w)
        _png(os.path.join(ws, "rgbs_b", f"{v:04d}.png"), host_b)
        for sub in ("depth_w", "depth_b"):
            _png(os.path.join(ws, sub, f"{v:04d}.png"), host_depth)
        frames.append((host_b * 255).astype(np.uint8))

        line = f"view {v}: {dt*1000:.1f} ms"
        if "pixels" in view:
            gt = view["pixels"].reshape(dataset.H, dataset.W, -1)
            if gt.shape[-1] == 4:
                gt_w = gt[..., :3] * gt[..., 3:] + (1 - gt[..., 3:])
                gt_b = gt[..., :3] * gt[..., 3:]
            else:
                gt_w = gt_b = gt
            _png(os.path.join(ws, "ground_truth_w", f"{v:04d}.png"), torch.clamp(gt_w, 0, 1).cpu())
            _png(os.path.join(ws, "ground_truth_b", f"{v:04d}.png"), torch.clamp(gt_b, 0, 1).cpu())
            for bg, img, gti in (("w", img_w, gt_w), ("b", img_b, gt_b)):
                for m in meters[bg]:
                    m.update(img, gti)
            line += (
                f" | PSNR_w {meters['w'][0].vals[-1]:.2f}"
                f" | PSNR_b {meters['b'][0].vals[-1]:.2f}"
            )
        log(line)

    summary = ["==== composition summary ====", f"objects: {objs}"]
    for bg in ("w", "b"):
        summary.append(f"bg={bg}: " + " | ".join(m.report() for m in meters[bg]))
    with open(log_path, "a") as f:
        f.write("\n".join(summary) + "\n")
    print("\n".join(summary))

    if write_video and len(frames) > 1:
        from focnerf_tpu_torch.utils.video import write_video as _wv

        _wv(os.path.join(ws, "composite.mp4"), frames, fps=10)
    return frames


def main(argv=None, device=None):
    """CLI entry; ``device`` None means ``cuda`` (raises without CUDA).
    Returns the composed frames."""
    opt = parse_options(argv)
    device = resolve_device(device)
    os.makedirs(opt.workspace, exist_ok=True)
    return evaluate_composition(opt, device=device)


if __name__ == "__main__":
    main()
