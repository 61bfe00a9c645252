"""The readings the limits of ``correct`` are set from, for one cell.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... --control-seeds 1,2,3 --seconds 1

Runs the cell once a seed in this one process (set-up, a window of
``--seconds``, no per-layer tracing), then the reference, and prints one
JSON line a seed: the program's gaps and, for the control seeds, those of
the reference computed one precision lower (and a generator's planted
faults). Needs a CUDA card.
"""

import argparse
import contextlib
import gc
import importlib
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="readings for the limits of one cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        files = harness.cell_files(ROOT, json.load(f), args.workload)
    gen = importlib.import_module(f"portbench.generators.{files['traffic']['generator']}")
    control = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        with tempfile.TemporaryDirectory(prefix="portbench-") as workdir:
            ctx = harness.Context(root=ROOT, cell=files["cell"], config=files["config"], traffic=files["traffic"],
                                  seed=seed, seconds=args.seconds, trace=False, device=torch.device("cuda"),
                                  workdir=workdir, cache=os.path.join(ROOT, "portbench", ".cache"),
                                  t_start=time.perf_counter())
            with contextlib.redirect_stdout(sys.stderr):
                out = gen.run(ctx)
            check = out.pop("check_data")
            del out
            gc.collect()
            torch.cuda.empty_cache()
            row = {"seed": seed, **gen.readings(ctx, check, seed in control)}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
