"""Run one cell of the port's benchmark once, and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the program (``focnerf_tpu_torch``). Needs CUDA cards, as many as the
cell asks for; exits non-zero and prints no result without them, without
the program, or when JAX or the JAX package was loaded. The last line of
standard output is the result (JSON); the last lines of standard error are
the numbers the check compared, each beside its limit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "portbench", ".cache", "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "portbench", ".cache", "torch_extensions"))
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    chips = harness.cell_files(ROOT, bench, args.workload)["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = harness.execute(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T_START, bench)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}; no result", file=sys.stderr)
        return 3
    print(f"portbench: window {json.dumps(result.pop('diag'))}", file=sys.stderr)
    print(f"portbench: set-up split (s from start) {json.dumps(result['setup_split_s'])}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
