"""The serving window's model FLOP utilization: the sigma and colour MLPs'
forward FLOPs (``work.forward_flops_per_sample``) at the samples the
window's views require, over the window's wall time and the bf16 peak.
Samples a view: the benchmark's plain march over the object's grid, for
every pose the window served."""

import collections

import torch

from portbench import work
from portbench.reference import nerf as ref


def read(ctx, trace):
    if trace.get("kind") != "render":
        return None
    check, c = trace["check"], ctx.config
    bits = ref.occupied_bits(check["grid"], c["density_thresh"])
    H, W = check["H"], check["W"]
    samples = 0.0
    with torch.no_grad():
        for v, n in collections.Counter(trace["views"]).items():
            pose = torch.from_numpy(check["poses"][v]).to(ctx.device)
            count = 0
            for s in range(0, H * W, 1 << 17):
                inds = torch.arange(s, min(s + (1 << 17), H * W), device=ctx.device)
                o, d = ref.camera_rays(pose, check["intrinsics"], H, W, inds)
                near, far = ref.near_far(o, d, c["bound"], c["min_near"])
                _, _, valid = ref.march(o, d, near, far, bits, bound=c["bound"], dt_gamma=c["dt_gamma"],
                                        max_steps=c["max_steps"], slab=check["slab"])
                count += int(valid.sum())
            samples += n * count
    return 100.0 * samples * work.forward_flops_per_sample(c) / trace["window_s"] / work.PEAK_BF16_FLOPS
