"""The training window's model FLOP utilization: the sigma and colour
MLPs' FLOPs (forward and backward, ``work.train_flops_per_sample``) at the
samples the window's rays require, over the window's wall time and the
bf16 peak. Samples a ray: the benchmark's plain march over the trainer's
occupancy grid at the window's start and at its end (the mean of the two),
on the checked steps' rays, each grid at the slab the trainer used then."""

import torch

from portbench import work
from portbench.generators.train import scene_for_reference
from portbench.reference import nerf as ref


def read(ctx, trace):
    if trace.get("kind") != "train":
        return None
    check, c = trace["check"], ctx.config
    scene = scene_for_reference(check["root"], check["feats"], ctx.device)
    slabs = [check["slab"], trace["slabs"][-1][1] if trace["slabs"] else check["slab"]]
    means = []
    with torch.no_grad():
        for bits, slab in zip(trace["bits"], slabs):
            counts = []
            for s in check["steps"]:
                b = ref.batch_of(scene, int(s["view"]), s["inds"].to(ctx.device), ctx.device)
                near, far = ref.near_far(b["rays_o"], b["rays_d"], c["bound"], c["min_near"])
                _, _, valid = ref.march(b["rays_o"], b["rays_d"], near, far, bits.to(ctx.device), bound=c["bound"],
                                        dt_gamma=c["dt_gamma"], max_steps=c["max_steps"], slab=slab,
                                        noise=s["noise"].to(ctx.device))
                counts.append(valid.sum(-1).double())
            means.append(float(torch.cat(counts).mean()))
    samples = trace["steps"] * trace["rays_per_step"] * sum(means) / len(means)
    flops = samples * work.train_flops_per_sample(c)
    return 100.0 * flops / trace["window_s"] / work.PEAK_BF16_FLOPS
