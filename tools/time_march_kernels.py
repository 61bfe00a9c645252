#!/usr/bin/env python3
"""Time the skip-walk kernel of one checkout of the port on the card, on
inputs saved once, so two checkouts compare on the same walks.

    python3 tools/time_march_kernels.py --make_inputs FILE [--work DIR]
    python3 tools/time_march_kernels.py --inputs FILE [--root DIR] [--label NAME] [--variants 32:32,16:4]

``--make_inputs`` trains ``chip_smoke.py``'s phase 5 field (``main_nerf -O``)
and its D-NeRF field (``phase_dnerf``) with this checkout, and saves
``[kernel-march]``'s walks (``chip_smoke.march_cases``: the -O batch at the
slabs 128, 32 and 16, the iterative round's start, restart and capped
restart; ``dnerf_march_cases``: two D-NeRF time slots) to FILE (about 3
minutes of command on one card).

``--inputs`` imports ``focnerf_tpu_torch`` from DIR (default: this
checkout), holds its ``march_rays_skip`` against the plain walk bit for bit
on every saved walk, and prints the kernel's own device time per call
(torch.profiler, 100 calls, the ``march_skip_kernel`` events alone: this
checkout's ``utils/measure.kernel_ms``) with the walk's mean samples and
leaps a ray and its longest walk.
``--variants lanes:ramp,...`` times each (lanes, ramp) of a checkout whose
wrapper has ``march_lanes`` as well as its own choice.

Run the parent and the change in one call, in turns (parent, change,
change, parent): times from different calls do not compare.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def make_inputs(path: str, work: str) -> None:
    import shutil

    import torch

    sys.path.insert(0, HERE)
    cs = load_smoke()
    dev = torch.device("cuda")
    smi = cs.phase_device()
    shutil.rmtree(work, ignore_errors=True)
    _, trainer = cs.phase_train(work, dev)
    ds = cs.train_dataset(os.path.join(work, "train_scene"), dev)
    val_ds = cs.train_dataset(os.path.join(work, "train_scene"), dev, "val")
    cases = cs.march_cases(trainer, ds, val_ds, dev)
    del trainer, ds, val_ds
    _, dnerf_trainer = cs.phase_dnerf(work, dev, smi)
    cases += cs.dnerf_march_cases(dnerf_trainer, dev)

    def cpu(x):
        return x.cpu() if torch.is_tensor(x) else x

    torch.save([(tag, tuple(cpu(a) for a in args), {k: cpu(v) for k, v in kw.items()}) for tag, args, kw, _ in cases],
               path)
    print(f"[march-inputs] {len(cases)} walks saved to {path} ({smi})")


def time_inputs(path: str, root: str, label: str, variants: str) -> int:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from focnerf_tpu_torch.ops import _build
    from focnerf_tpu_torch.ops import marching

    # this checkout's timer, for every checkout timed
    spec = importlib.util.spec_from_file_location("measure", os.path.join(HERE, "focnerf_tpu_torch/utils/measure.py"))
    measure = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(measure)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    _build.build_all()
    print(f"[{label}] {smi.splitlines()[0]}; march kernel from {_build.CSRC_DIR}", flush=True)
    choices = [None]
    if variants and hasattr(marching, "march_lanes"):
        choices += [tuple(int(x) for x in v.split(":")) for v in variants.split(",")]
    own = getattr(marching, "march_lanes", None)
    failed = 0
    for tag, args, kw in torch.load(path):
        args = tuple(a.cuda() for a in args)
        kw = {k: v.cuda() if torch.is_tensor(v) else v for k, v in kw.items()}
        want = marching.march_skip_plain(*args, **kw)
        for choice in choices:
            if choice is not None:
                marching.march_lanes = lambda n, slab, c=choice: c
            n = args[0].shape[0]
            name = f"lanes:ramp {choice[0]}:{choice[1]}" if choice else \
                "own choice {}:{}".format(*own(n, kw["slab"])) if own else "one thread a ray"
            try:
                got = marching.march_rays_skip(*args, **kw)
                same = all(torch.equal(getattr(got, f), getattr(want, f)) for f in ("ts", "dts", "valid", "count"))
                ms, events = measure.kernel_ms(lambda: marching.march_rays_skip(*args, **kw), "march_skip_kernel")
            finally:
                if own is not None:
                    marching.march_lanes = own
            leaps = got.ray_iters.long() - got.count
            failed += not same
            print(f"[{label}] {tag} [{n} rays, slab {kw['slab']}] {name}: device {ms:.5f} ms "
                  f"({events} of 100 launches traced); {'equal to the plain walk' if same else 'DIFFERS FROM THE PLAIN WALK'}"
                  f"; mean samples {got.count.float().mean():.1f}, leaps {leaps.float().mean():.1f} a ray (most "
                  f"{int(leaps.max())}), longest walk {int(got.iters)}", flush=True)
    return 1 if failed else 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--make_inputs", default="", help="train the fields and save the walks to this file")
    ap.add_argument("--work", default=os.path.join(HERE, "workspace_march"), help="--make_inputs' workspace")
    ap.add_argument("--inputs", default="", help="time the walks saved in this file")
    ap.add_argument("--root", default=HERE, help="checkout whose focnerf_tpu_torch is timed")
    ap.add_argument("--label", default="", help="name printed on every line")
    ap.add_argument("--variants", default="", help="lanes:ramp pairs to time besides the wrapper's own")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_march_kernels: CUDA is not available", file=sys.stderr)
        return 2
    if args.make_inputs:
        make_inputs(args.make_inputs, args.work)
        return 0
    if not args.inputs:
        ap.error("give --make_inputs or --inputs")
    return time_inputs(args.inputs, args.root, args.label or os.path.abspath(args.root), args.variants)


if __name__ == "__main__":
    sys.exit(main())
