#!/usr/bin/env python3
"""Time the kernels at the CLIP step's shapes on the card.

    python3 tools/time_clip_composite.py [--n 4356] [--t 128] [--iters 100]

Builds the port's kernels and times ``composite_rays_fused`` and
``composite_rays_fused_backward`` at [n, t], T_thresh 0 and a white
background (``chip_smoke.py``'s ``[clip]`` shape), on ``chip_smoke.py``'s
inputs with and without its thin rays, three ways:

  - warm: the same inputs relaunched, so they stay in the 50 MB L2;
  - rotated: 16 copies of the inputs in turn (``chip_smoke.CLIP_ROTATE``);
  - flushed: a 256 MB buffer zeroed before every launch.

Then the table gradient of the -O encode at n x t points (its 193 MB of
inputs and output do not fit in L2), beside ``index_add_`` of the same
contributions. Each line gives the kernel's own events in a torch.profiler
trace (matched by name, counted against the launches made), their median
and mean in ms, the whole trace's device time per call as
``utils/measure.device_ms`` sums it, and the byte bound (composite: every
sample read once, 24 B a sample, 20 B a ray written; the backward also
writes 16 B a sample and reads 52 B a ray; the table gradient as
``chip_smoke.py``'s ``[clip]`` counts it).
"""

from __future__ import annotations

import argparse
import itertools
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4356, help="rays")
    ap.add_argument("--t", type=int, default=128, help="samples a ray")
    ap.add_argument("--iters", type=int, default=100, help="timed launches a way")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("time_clip_composite: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from focnerf_tpu_torch.ops import _build
    from focnerf_tpu_torch.ops import composite as C
    from focnerf_tpu_torch.utils.measure import device_events

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    _build.build_all()
    n, T = args.n, args.t
    f_bound = (n * T * 24 + n * 20) / smoke.HBM_BYTES_PER_S * 1e3
    b_bound = (n * T * 40 + n * 52) / smoke.HBM_BYTES_PER_S * 1e3
    print(f"[time_clip_composite] {smi.splitlines()[0]}; [{n},{T}] T_thresh 0, white background; byte bounds "
          f"forward {f_bound:.5f} ms, backward {b_bound:.5f} ms", flush=True)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")  # 256 MB
    g = torch.Generator(device="cuda").manual_seed(1)
    cot = tuple(torch.randn(sh, generator=g, device="cuda") for sh in ((n, 3), (n,), (n,)))

    def timed(what, kernel, fn, sets, flushed):
        turn = itertools.cycle(sets)
        for _ in range(5):
            fn(*next(turn))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                if flushed:
                    flush.zero_()
                fn(*next(turn))
            torch.cuda.synchronize()
        events = device_events(prof)
        own = [ms for name, ms in events if kernel in name]
        every = sum(ms for _, ms in events) / args.iters
        print(f"[time_clip_composite] {what}: {len(own)} kernel events for {args.iters} launches, median "
              f"{statistics.median(own):.5f} ms, mean {statistics.fmean(own):.5f} ms; device_ms's sum per call "
              f"{every:.5f} ms", flush=True)

    for thin in (True, False):
        sig, rgb, dts, ts, _ = smoke.composite_inputs(T, thin=thin, n=n)
        ts = ts / ts[:, -1:]
        with torch.no_grad():
            outs = C.composite_rays_fused(sig, rgb, dts, ts, bg_color=1.0, T_thresh=0.0)
        one = [(sig, rgb, dts, ts, *outs)]
        copies = [tuple(x.clone() for x in one[0]) for _ in range(smoke.CLIP_ROTATE)]

        def fwd(s, c, d, t, *o):
            return C.composite_rays_fused(s, c, d, t, bg_color=1.0, T_thresh=0.0)

        def bwd(s, c, d, t, *o):
            return C.composite_rays_fused_backward(s, c, d, t, 1.0, o, cot, T_thresh=0.0)

        for way, sets, flushed in (("warm", one, False), ("rotated", copies, False), ("flushed", one, True)):
            inputs = "thin rays" if thin else "no thin rays"
            timed(f"forward, {inputs}, {way}", "composite_forward", fwd, sets, flushed)
            timed(f"backward, {inputs}, {way}", "composite_backward", bwd, sets, flushed)
        del sig, rgb, dts, ts, outs, one, copies

    from focnerf_tpu_torch.config import parse_options
    from focnerf_tpu_torch.ops import hashgrid as thg

    cfg = parse_options(["scene", "-O"]).nerf_config()
    rows, weights, g_out, cols, n_rows = smoke.table_grad_inputs(cfg, samples=T, n=n)
    m, J = rows.shape
    level_dim = cfg.level_dim
    col_level = torch.tensor(cols, dtype=torch.int32, device="cuda")
    contrib = (weights[..., None] * g_out.reshape(m, -1, level_dim).index_select(1, col_level)).reshape(-1, level_dim)
    flat = rows.reshape(-1)
    nbytes = m * J * 8 + g_out.numel() * 4 + n_rows * level_dim * 4 + J * 4
    print(f"[time_clip_composite] hashgrid_table_grad {m} points x {J} columns into {n_rows} x {level_dim} rows: byte "
          f"bound {nbytes / smoke.HBM_BYTES_PER_S * 1e3:.5f} ms ({nbytes} B)", flush=True)
    timed("hashgrid_table_grad", "table_grad", lambda: thg.hashgrid_table_grad(rows, weights, g_out, cols, n_rows),
          [()], False)
    timed("index_add_ (its zero fill left out)", "index", lambda: torch.zeros(
        (n_rows, level_dim), device="cuda").index_add_(0, flat, contrib), [()], False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
