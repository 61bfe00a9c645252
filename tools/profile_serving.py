"""Where the time of one served view goes, on a CUDA card.

    python tools/profile_serving.py [--res 800] [--out workspace_profile/profile_serving.json]

Builds the full-width default model of ``main_nerf --test -O`` with
``focnerf_tpu_torch.utils.measure.seeded_model`` (seeded weights, density
grid = the field's sigma at every cell centre, as chip_smoke.py does),
warms up with one view, then renders one RES x RES view twice more:

  1. with CUDA events around each stage of ``render_rays_occupancy``
     (near/far, march, hash encode (``density_fn``'s ``hashgrid_encode_c2f``:
     the encode kernel on the card), density = encode + sigma MLP, color,
     composite): the stages run in order on one stream, so each event span is
     that stage's device time plus any wait for the host inside it;
  2. under torch.profiler: the device's busy time (the union of the
     device-side events' intervals) against the view's wall time, the
     number of device events, and the top kernels by device time.

Imports only the port (never JAX). Prints one line per stage and writes
everything to ``--out`` as JSON.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _stage_timer(spans):
    import torch

    def wrap(name, fn):
        def timed(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            spans[name].append((start, end))
            return out

        return timed

    return wrap


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--res", type=int, default=800)
    p.add_argument("--out", default=os.path.join(ROOT, "workspace_profile", "profile_serving.json"))
    args = p.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from focnerf_tpu_torch import resolve_device
    from focnerf_tpu_torch.config import parse_options
    from focnerf_tpu_torch.core.camera import rand_poses
    from focnerf_tpu_torch.models import nerf
    from focnerf_tpu_torch.ops.occupancy import occupancy_bitfield
    from focnerf_tpu_torch.render import renderer
    from focnerf_tpu_torch.utils.measure import busy_ms as device_busy_ms, device_events, seeded_model

    dev = resolve_device(None)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    opt = parse_options(["scene", "--test", "-O"])
    params, cfg, occ = seeded_model(opt, dev)
    bits = occupancy_bitfield(occ, opt.density_thresh)
    pose = rand_poses(np.random.default_rng(0), 1, radius=4.0)[0]
    res = args.res
    intr = np.array([1.2 * res, 1.2 * res, res / 2, res / 2], np.float32)
    feat = torch.from_numpy(np.random.default_rng(1).normal(size=144).astype(np.float32)).to(dev)
    kw = dict(obj_feat=feat, bg_color=1.0, occ_bits=bits, dt_gamma=opt.dt_gamma,
              max_steps=opt.max_steps, slab=max(opt.train_slab, 64), min_near=opt.min_near,
              max_ray_batch=opt.max_ray_batch)

    def view():
        img, _ = renderer.render_image(params, cfg, pose, intr, res, res, **kw)
        torch.cuda.synchronize()
        return img

    view()  # warm-up

    spans = collections.defaultdict(list)
    wrap = _stage_timer(spans)
    patched = [
        (renderer, "near_far_from_aabb"), (renderer, "march_rays"), (renderer, "density_fn"),
        (nerf, "hashgrid_encode_c2f"), (renderer, "color_fn"), (renderer, "composite_rays_fused"),
    ]
    originals = [getattr(m, n) for m, n in patched]
    for (m, n), fn in zip(patched, originals):
        setattr(m, n, wrap(n, fn))
    try:
        t0 = time.time()
        view()
        wall_ms = (time.time() - t0) * 1e3
    finally:
        for (m, n), fn in zip(patched, originals):
            setattr(m, n, fn)
    stages = {n: sum(s.elapsed_time(e) for s, e in spans[n]) for _, n in patched}

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        view()
        prof_wall_ms = (time.time() - t0) * 1e3
    events = device_events(prof)
    busy_ms = device_busy_ms(prof)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for name, ms in events:
        by_name[name][0] += ms
        by_name[name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:15]

    print(f"[profile] {smi}; view {res}x{res}, chunks of {opt.max_ray_batch} rays, slab {kw['slab']}")
    print(f"[profile] wall {wall_ms:.1f} ms per view (stage-timed run)")
    for name, ms in stages.items():
        print(f"[profile]   {name:22s} {ms:9.2f} ms  {ms / wall_ms:6.1%} of wall")
    print(f"[profile] profiled run: wall {prof_wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({busy_ms / prof_wall_ms:.1%}), {len(events)} device events (kernel launches and copies)")
    for name, (ms, count) in top:
        print(f"[profile]   {ms:9.2f} ms  {count:6d}x  {name[:100]}")
    out = {
        "device": smi, "res": res, "wall_ms": wall_ms, "stages_ms": stages,
        "profiled_wall_ms": prof_wall_ms, "device_busy_ms": busy_ms, "device_events": len(events),
        "top_kernels": [{"name": n, "device_ms": ms, "count": c} for n, (ms, c) in top],
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
