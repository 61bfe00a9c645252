"""How often, and why, the D-NeRF train step on the card disagrees with the
CPU's: ``chip_smoke.py``'s ``[dnerf-reference]`` check over many batches.

Trains the smoke's D-NeRF as its ``[dnerf]`` phase does (``main_dnerf -O
--dnerf_variant deform`` at full width on the moving sphere, DNERF_ITERS
steps, DNERF_SLOTS time slots, DNERF_FLAGS) and prints its val PSNR, then
runs ``chip_smoke.dnerf_step_card_vs_cpu`` with the trained params on
``--cases`` batches (a camera and draws per seed, t spread over [0, 1]),
each as the uniform step at 128 samples and as the time slot's skip walk.
Per case it prints the loss and gradient errors of the full loss and of
the loss over the rays on which both devices took the same piece of every
piecewise function (encode cells, ReLUs, the composite's early exit, the
march's count), with the count of rays left out; then the worst of each
over all cases.

    python tools/dnerf_reference_sweep.py [--cases 24]

Needs one CUDA card; writes its workspace to ``workspace_dnerf_sweep/``.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", type=int, default=24, help="batches (each run as both steps)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("dnerf_reference_sweep: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import dataclasses

    import chip_smoke as cs
    from focnerf_tpu_torch.apps import main_dnerf
    from focnerf_tpu_torch.config import parse_options
    from focnerf_tpu_torch.train.dnerf_steps import dnerf_step_draws

    smi = cs.phase_device()
    cs.phase_build()
    dev = torch.device("cuda")
    work = os.path.join(ROOT, "workspace_dnerf_sweep")
    shutil.rmtree(work, ignore_errors=True)
    scene = os.path.join(work, "dnerf_scene")
    argv = [scene, "-O", "--dnerf_variant", "deform", "--workspace", os.path.join(work, "dnerf_ws"), "--iters",
            str(cs.DNERF_ITERS), "--time_slots", str(cs.DNERF_SLOTS), "--ckpt_interval", "1000", *cs.DNERF_FLAGS]
    cs.write_dynamic_scene(scene, parse_options(argv).scale)
    t0 = time.time()
    trainer = main_dnerf.main(argv, device=dev)
    losses = trainer.step_losses
    print(f"[sweep] trained {len(losses)} steps in {time.time() - t0:.1f} s: loss first 50 "
          f"{sum(losses[:50]) / 50:.5f}, last 50 {sum(losses[-50:]) / 50:.5f}; val PSNR "
          f"{trainer.last_eval_results['PSNR']:.3f} dB ({smi})", flush=True)
    cfg = dataclasses.replace(trainer.cfg, compute_dtype=torch.float32)
    params = {k: [w.detach().cpu() for w in v] if isinstance(v, list) else v.detach().cpu()
              for k, v in trainer.state.params.items()}
    occ_kw = dict(dt_gamma=trainer.dt_gamma, max_steps=trainer.max_steps, slab=64)
    worst = {}
    t0 = time.time()
    for seed in range(args.cases):
        t = round((seed + 0.5) / args.cases, 4)
        _, batch = cs.dnerf_reference_batch(100 + seed, t)
        skip = trainer._occ_bits_for_batch({"time": torch.tensor(t, device=dev)}).cpu()
        for step, kw in (("uniform", dict(num_steps=128)), ("skip walk", occ_kw)):
            draws = dnerf_step_draws(torch.Generator().manual_seed(seed), 512, "cpu",
                                     num_steps=kw.get("num_steps", 0))
            r = cs.dnerf_step_card_vs_cpu(params, cfg, batch, draws, kw, skip, unmasked=True)
            share = r["excluded"] / r["rays"]
            row = {"excluded share": share, "points differ share": r["points_differ"] / r["points"]}
            for name in ("full", "masked"):
                row[f"{name} loss rel"] = r[name]["loss_rel"]
                row[f"{name} grad rel"] = max(r[name]["grad_rel"].values())
            for k, v in row.items():
                worst[step, k] = max(worst.get((step, k), 0.0), v)
            print(f"[sweep] seed {seed} t={t} {step}: {r['points_differ']} of {r['points']} encode inputs differ, "
                  f"{r['excluded']} of {r['rays']} rays took another piece ({r['cells']} an encode cell, {r['relus']} a "
                  f"ReLU, {r['exits']} the early exit, {r['counts']} the march count); full loss: loss rel "
                  f"{r['full']['loss_rel']:.3g}, grad rel "
                  + ", ".join(f"{k} {v:.3g}" for k, v in r["full"]["grad_rel"].items())
                  + f"; without those rays: loss rel {r['masked']['loss_rel']:.3g}, grad rel "
                  + ", ".join(f"{k} {v:.3g}" for k, v in r["masked"]["grad_rel"].items()), flush=True)
    print(f"[sweep] {args.cases} batches x 2 steps in {time.time() - t0:.1f} s ({smi}); worst over the batches:")
    for (step, k), v in worst.items():
        print(f"[sweep]   {step}: {k} {v:.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
