#!/usr/bin/env python3
"""Time the composite kernels of one checkout of the port on the card.

    python3 tools/time_composite_kernels.py [--root DIR] [--label NAME]

Imports ``focnerf_tpu_torch`` from ``DIR`` (default: this checkout), builds
its kernels, and prints the device time per call (torch.profiler, 100
calls; ``utils/measure.device_ms`` of that checkout) of:

  - the forward (``composite_rays_fused``) on ``chip_smoke.py``'s inputs at
    [4096, 128] with T_thresh 1e-4 and 0, at [4096, 16] and at
    [65536, 16], T_thresh 1e-4, a scalar background;
  - ``composite_rays_resume`` at [65536, 16] with a carried optical depth
    U[0, 8], where the checkout has it;
  - the backward at [4096, 128] and [4096, 16], T_thresh 1e-4.

Run it on two checkouts in one call (parent, change, change, parent) to
compare them on one card: times from different calls do not compare.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE, help="checkout whose focnerf_tpu_torch is timed")
    ap.add_argument("--label", default="", help="name printed on every line")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("time_composite_kernels: CUDA is not available", file=sys.stderr)
        return 2
    from focnerf_tpu_torch.ops import _build
    from focnerf_tpu_torch.ops import composite as C
    from focnerf_tpu_torch.utils.measure import device_ms

    # chip_smoke.py of this checkout makes the inputs, for every checkout timed
    spec = importlib.util.spec_from_file_location("smoke_inputs", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    _build.build_all()
    label = args.label or os.path.abspath(args.root)
    print(f"[{label}] {smi.splitlines()[0]}; kernels from {_build.CSRC_DIR}")

    def line(what, fn):
        fn()
        torch.cuda.synchronize()
        ms, span = device_ms(fn, iters=100)
        print(f"[{label}] {what}: device {ms:.5f} ms (call span {span:.4f} ms)", flush=True)

    for t, n, thresh in ((128, 4096, 1e-4), (128, 4096, 0.0), (16, 4096, 1e-4), (16, 65536, 1e-4)):
        sig, rgb, dts, ts, _ = smoke.composite_inputs(t, n=n)
        line(f"composite_rays_fused [{n},{t}] T_thresh={thresh:g}",
             lambda: C.composite_rays_fused(sig, rgb, dts, ts, bg_color=1.0, T_thresh=thresh))
    if hasattr(C, "composite_rays_resume"):
        od0 = torch.rand(n, generator=torch.Generator(device="cuda").manual_seed(5), device="cuda") * 8.0
        line(f"composite_rays_resume [{n},{t}] od0 U[0, 8] T_thresh=1e-4",
             lambda: C.composite_rays_resume(sig, rgb, dts, ts, od0, T_thresh=1e-4))
    for t in (128, 16):
        sig, rgb, dts, ts, bg = smoke.composite_inputs(t)
        g = torch.Generator(device="cuda").manual_seed(1)
        cot = tuple(torch.randn(s, generator=g, device="cuda") for s in ((4096, 3), (4096,), (4096,)))
        with torch.no_grad():
            outs = C.composite_rays_fused(sig, rgb, dts, ts, bg_color=bg, T_thresh=1e-4)
        line(f"composite_rays_fused_backward [4096,{t}] T_thresh=1e-4",
             lambda: C.composite_rays_fused_backward(sig, rgb, dts, ts, bg, outs, cot, T_thresh=1e-4))
    return 0


if __name__ == "__main__":
    sys.exit(main())
