"""PSNR rows of the PyTorch port (focnerf_tpu_torch), one command: the
twin of tools/parity.py for the port's ``main_nerf`` and ``main_voxel``.

    python tools/parity_torch.py --family dynvoxel,kplanes --seeds 0 --iters 3000 --res 400
    python tools/parity_torch.py --family hash --seeds 0 --iters 600 --res 800

Families: hash (``main_nerf -O`` with tools/parity.py's run_hash flags),
dense, vm (rank 16), dynvoxel, kplanes (rank 8) (``main_voxel``, at
``--bake_res min(res, 256)``). Without ``--data`` the scenes are the port's procedural stand-ins
with tools/parity.py's geometry: ``hard_<res>_<gt>`` (``make_hard_scene``)
and, for the dynamic families, ``harddyn_<res>_<gt>``
(``make_hard_dynamic_scene``). Rows are printed as PARITY.md's, with the
card's name; this script writes no file outside ``--workspace``.
``--cpu`` runs on the CPU (a smoke at tiny sizes).
"""

from __future__ import annotations

import argparse
import io
import os
import re
import shutil
import sys
import time
from contextlib import redirect_stdout

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def run_hash(scene, iters, seed, workspace, device, *, num_rays=4096, num_steps=512, extra=()):
    from focnerf_tpu_torch.apps.main_nerf import main as train_main

    ws = os.path.join(workspace, f"hashO_s{seed}")
    for stale in (ws, ws + "_background"):
        shutil.rmtree(stale, ignore_errors=True)
    args = [
        scene, "-O", "--workspace", ws, "--iters", str(iters), "--disable_yolo", "--seed", str(seed),
        "--num_rays", str(num_rays), "--num_steps", str(num_steps), "--scale", "1.0", "--bound", "1.0",
        "--no-eval_save_images", "--mesh_res", "0", "--eval_interval", "100", "--ckpt_interval", "10",
        "--ckpt", "scratch",
    ] + list(extra)
    t0 = time.time()
    (trainer,) = train_main(args, device=device)
    return {"psnr": trainer.last_eval_results.get("PSNR"), "train_s": round(time.time() - t0, 1)}


def run_voxel(scene, family, iters, seed, workspace, device, *, res=128, extra=()):
    from focnerf_tpu_torch.apps.main_voxel import main as voxel_main

    ws = os.path.join(workspace, f"{family}_s{seed}")
    shutil.rmtree(ws, ignore_errors=True)  # no warm start from an earlier run
    args = [scene, "--workspace", ws, "--iters", str(iters), "--bake_res", str(res), "--seed", str(seed),
            "--scale", "1.0", "--bound", "1.0"] + list(extra)
    args += {"vm": ["--voxel_vm", "16"], "kplanes": ["--voxel_kplanes", "8"],
             "dynvoxel": ["--voxel_dynamic"]}.get(family, [])
    buf = io.StringIO()
    t0 = time.time()
    with redirect_stdout(buf):
        voxel_main(args, device=device)
    out = buf.getvalue()
    sys.stdout.write(out)
    val = re.findall(r"val PSNR: ([0-9.]+) dB", out)
    train = re.findall(r"train PSNR ([0-9.]+) dB", out)
    return {
        "psnr": float(val[-1]) if val else (float(train[-1]) if train else None),
        "train_s": round(time.time() - t0, 1),
    }


def _row(tag, dataset, iters, rows, card):
    import numpy as np

    ps = [r["psnr"] for r in rows if r["psnr"] is not None]
    secs = sum(r["train_s"] for r in rows)
    if not ps:
        print(f"| {tag} | {dataset} | {iters} | FAILED | {secs:.0f}s | {card} |")
        return
    print(f"| {tag} | {dataset} | {iters} | {np.mean(ps):.2f} ± {np.std(ps):.2f} dB (n={len(ps)}) | {secs:.0f}s "
          f"| {card} |", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data", type=str, default=None, help="a real scene (blender/colmap layout)")
    p.add_argument("--family", default="hash", help="hash | dense | vm | dynvoxel | kplanes (comma lists ok)")
    p.add_argument("--seeds", default="0")
    p.add_argument("--iters", type=int, default=500)
    p.add_argument("--res", type=int, default=128, help="image side of the procedural scenes; voxel bake_res cap")
    p.add_argument("--gt_res", type=int, default=None, help="procedural GT voxelization")
    p.add_argument("--views", type=int, default=30)
    p.add_argument("--num_rays", type=int, default=4096)
    p.add_argument("--num_steps", type=int, default=512)
    p.add_argument("--train_extra", default="", help="extra flags appended to every run")
    p.add_argument("--workspace", type=str, default="workspace_parity")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    device = "cpu" if args.cpu else "cuda"
    card = "CPU"
    if not args.cpu:
        import subprocess

        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    os.makedirs(args.workspace, exist_ok=True)
    fams = args.family.split(",")
    seeds = [int(s) for s in args.seeds.split(",")]
    extra = args.train_extra.split()

    from focnerf_tpu_torch.data.procedural import make_hard_dynamic_scene, make_hard_scene

    scenes = {}
    for fam in fams:
        dynamic = fam in ("dynvoxel", "kplanes")
        if args.data is not None:
            scenes[fam] = args.data
        elif dynamic:
            gt = args.gt_res or min(128, max(32, (args.res // 3) // 32 * 32))
            t0 = time.time()
            scenes[fam] = make_hard_dynamic_scene(
                os.path.join(args.workspace, f"harddyn_{args.res}_{gt}"), n_times=max(4, args.views // 4),
                views_per_time=4, H=args.res, W=args.res, gt_res=gt, device=device)
            print(f"[parity] scene {scenes[fam]} ready in {time.time() - t0:.1f} s", flush=True)
        else:
            gt = args.gt_res or min(256, max(32, (args.res // 3) // 32 * 32))
            t0 = time.time()
            scenes[fam] = make_hard_scene(
                os.path.join(args.workspace, f"hard_{args.res}_{gt}"), n_train=args.views,
                n_val=max(4, args.views // 6), n_test=max(4, args.views // 6), H=args.res, W=args.res, gt_res=gt,
                device=device)
            print(f"[parity] scene {scenes[fam]} ready in {time.time() - t0:.1f} s", flush=True)

    print("| run | scene | iters | val PSNR | wall | card |")
    for fam in fams:
        dataset = os.path.basename(os.path.normpath(scenes[fam]))
        rows = []
        for s in seeds:
            if fam == "hash":
                r = run_hash(scenes[fam], args.iters, s, args.workspace, device, num_rays=args.num_rays,
                             num_steps=args.num_steps, extra=extra)
                tag = "hash/O"
            else:
                r = run_voxel(scenes[fam], fam, args.iters, s, args.workspace, device, res=min(args.res, 256),
                              extra=extra)
                tag = fam
            cell = f"{r['psnr']} dB" if r["psnr"] is not None else "FAILED"
            print(f"| {tag} seed {s} (port) | {dataset} | {args.iters} | {cell} | {r['train_s']:.0f}s | {card} |",
                  flush=True)
            rows.append(r)
        _row(f"{tag} (port)", dataset, args.iters, rows, card)


if __name__ == "__main__":
    main()
