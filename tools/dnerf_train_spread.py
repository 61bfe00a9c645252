"""The spread of ``chip_smoke.py``'s ``[dnerf]`` training across runs of one
tree: N copies of ``main_dnerf -O --dnerf_variant deform`` on the smoke's
moving sphere (DNERF_ITERS steps, DNERF_SLOTS time slots, and any extra
flags: the smoke passes DNERF_FLAGS), in N processes on one card at once. The table gradient's atomics
sum in another order each run, so the runs part; this prints each run's
loss curve ends, val PSNR and whether its deformation net is still alive
(the share of probe points with a non-zero dx and of hidden units that
fire on any of them), then a summary.

    python tools/dnerf_train_spread.py --runs 4 [--iters 700] [-- --lr_net 1e-3]

Needs one CUDA card; writes its workspaces to ``workspace_dnerf_spread/``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def deform_liveness(trainer, n: int = 65536) -> dict:
    """Share of n probe points (uniform in the bound box, t in [0, 1]) with a
    non-zero dx, mean |dx|, and per hidden layer the share of units that
    fire on at least one of them (``mlp_apply`` on the first i + 1 layers)."""
    import torch

    from focnerf_tpu_torch.models.mlp import mlp_apply
    from focnerf_tpu_torch.ops.freq import freq_encode

    cfg, ws = trainer.cfg, trainer.state.params["deform_net"]
    dev = ws[0].device
    g = torch.Generator(device=dev).manual_seed(0)
    x = (torch.rand((n, 3), generator=g, device=dev) * 2 - 1) * cfg.bound
    t = torch.rand((n, 1), generator=g, device=dev)
    h = torch.cat([freq_encode(x, cfg.freq_deg_x), freq_encode(t, cfg.freq_deg_t)], -1)
    with torch.no_grad():
        units = [float((mlp_apply(ws[: i + 1], h, cfg.compute_dtype) > 0).any(0).float().mean())
                 for i in range(len(ws) - 1)]
        dx = mlp_apply(ws, h, cfg.compute_dtype)
    return {"moving_share": float((dx.abs().sum(-1) > 0).float().mean()), "mean_abs_dx": float(dx.abs().mean()),
            "live_units": units}


def worker(args, extra) -> int:
    import torch

    sys.path.insert(0, ROOT)
    from focnerf_tpu_torch.apps import main_dnerf

    import chip_smoke as cs

    ws = os.path.join(args.work, f"ws_{args.worker}")
    argv = [os.path.join(args.work, "scene"), "-O", "--dnerf_variant", "deform", "--workspace", ws, "--iters",
            str(args.iters), "--time_slots", str(cs.DNERF_SLOTS), "--ckpt_interval", "1000"] + extra
    t0 = time.time()
    trainer = main_dnerf.main(argv, device=torch.device("cuda"))
    losses = trainer.step_losses
    out = {"run": args.worker, "seconds": round(time.time() - t0, 1), "steps": len(losses),
           "loss_first_50": sum(losses[:50]) / 50, "loss_last_50": sum(losses[-50:]) / 50,
           "val_psnr": trainer.last_eval_results["PSNR"], **deform_liveness(trainer)}
    print("[spread-run] " + json.dumps(out), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--iters", type=int, default=0, help="0: chip_smoke's DNERF_ITERS")
    ap.add_argument("--worker", type=int, default=-1, help=argparse.SUPPRESS)
    ap.add_argument("--work", default=os.path.join(ROOT, "workspace_dnerf_spread"), help=argparse.SUPPRESS)
    argv = sys.argv[1:]
    extra = argv[argv.index("--") + 1:] if "--" in argv else []
    args = ap.parse_args(argv[: argv.index("--")] if "--" in argv else argv)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    args.iters = args.iters or cs.DNERF_ITERS
    if args.worker >= 0:
        return worker(args, extra)
    import torch

    if not torch.cuda.is_available():
        print("dnerf_train_spread: CUDA is not available", file=sys.stderr)
        return 2
    smi = cs.phase_device()
    cs.phase_build()
    shutil.rmtree(args.work, ignore_errors=True)
    from focnerf_tpu_torch.config import parse_options

    cs.write_dynamic_scene(os.path.join(args.work, "scene"), parse_options(["scene", "-O"] + extra).scale)
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker", str(i), "--iters",
                               str(args.iters), "--work", args.work, "--"] + extra,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(args.runs)]
    runs = []
    for i, p in enumerate(procs):
        out, _ = p.communicate()
        lines = [ln for ln in out.splitlines() if ln.startswith("[spread-run] ")]
        if p.returncode != 0 or not lines:
            print(out[-3000:])
            print(f"[spread] run {i} failed with exit code {p.returncode}")
            continue
        runs.append(json.loads(lines[-1][len("[spread-run] "):]))
        print(lines[-1], flush=True)
    dead = sum(r["moving_share"] == 0.0 for r in runs)
    psnr = sorted(round(r["val_psnr"], 3) for r in runs)
    print(f"[spread] {len(runs)} of {args.runs} runs of {args.iters} steps (extra flags {extra or 'none'}) in "
          f"{time.time() - t0:.1f} s, {args.runs} at once ({smi}): val PSNR {psnr} dB; deformation dead (dx = 0 on "
          f"every probe point) in {dead}")
    return 0 if len(runs) == args.runs else 1


if __name__ == "__main__":
    sys.exit(main())
