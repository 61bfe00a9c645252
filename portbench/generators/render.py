"""Traffic generator ``render``: one client rendering views in a closed loop.

Set-up builds the test-mode trainer of ``main_nerf`` (``--test`` and the
traffic's ``cli``, the configuration's widths), loads the benchmark's
seeded weights into its EMA weights (what the test mode renders), gives it
the occupancy grid of the frozen object (``scenes.occupancy_from_volume``)
and renders one view to warm up. The window renders the scene's ``split``
poses, in an order drawn from ``--seed``, one after the other through
``Trainer._render_view`` with ``Trainer._render_kwargs()`` (what
``Trainer.test`` renders with: the oneshot chunk loop, the ladder march),
each image and depth copied to the host as the client receives them,
until ``--seconds`` have passed at a view's end. Every view carries its
own seeded 144-d object feature.

After the window, with the program freed, the plain reference renders
``check_views`` of the finished views (the last one and others drawn from
the seed) from the same weights, grid and features; ``gaps`` between the
two decide ``correct``.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from portbench import common, scenes, tracing
from portbench.reference import nerf as ref


def _grid(root: str, device):
    """The density grid of the frozen object: 1 where a cell holds density,
    0 elsewhere. The march reads the cells above min(mean, density_thresh),
    which are the occupied ones whatever positive value they hold."""
    occ = torch.from_numpy(np.load(os.path.join(root, "occupancy.npy"))).to(device)
    return occ.float()


def setup(ctx):
    from focnerf_tpu_torch.config import parse_options
    from focnerf_tpu_torch.data.provider import NeRFDataset
    from focnerf_tpu_torch.ops.occupancy import OccupancyState
    from focnerf_tpu_torch.train.state import param_leaves
    from focnerf_tpu_torch.train.trainer import Trainer

    device, c, t = ctx.device, ctx.config, ctx.traffic
    root = scenes.ensure_scene(t["scene"], device, ctx.cache)
    ctx.mark("scene")
    argv = [root, *t["cli"], "--workspace", os.path.join(ctx.workdir, "ws"), "--bound", str(c["bound"]),
            "--scale", str(t["scale"]), "--dt_gamma", str(c["dt_gamma"]), "--max_steps", str(c["max_steps"]),
            "--min_near", str(c["min_near"]), "--density_thresh", str(c["density_thresh"]),
            "--max_ray_batch", str(t["max_ray_batch"]), "--grid_levels", str(c["num_levels"]),
            "--grid_featdim", str(c["level_dim"])]
    opt = parse_options(argv)
    ds = NeRFDataset(opt.dataset_options(), split=t["split"], device=device)
    feats = common.seeded_features(ds.n_views, c["yolo_feats_dim"], ctx.seed, device)
    ds.obj_feats = feats.cpu().numpy()
    ctx.mark("scene_read")
    cfg = common.program_config(c, opt.nerf_config())
    # main_nerf's test mode: the trainer's defaults render (oneshot, ladder march)
    trainer = Trainer("ngp", cfg, workspace=opt.workspace, use_checkpoint="scratch", num_steps=opt.num_steps,
                      upsample_steps=opt.upsample_steps, max_ray_batch=opt.max_ray_batch, min_near=opt.min_near,
                      use_occupancy=opt.cuda_ray, dt_gamma=opt.dt_gamma, max_steps=opt.max_steps,
                      train_slab=opt.train_slab, density_thresh=opt.density_thresh, device=device)
    ctx.mark("trainer")
    weights = common.seeded_weights(c, ctx.seed, device, math.sqrt(3.0) * t["table_rms"])
    common.load_into(param_leaves(trainer.state.ema_params), weights)
    grid = _grid(root, device)
    trainer.occupancy = OccupancyState(grid.clone(), grid.mean(), torch.tensor(16, dtype=torch.int32, device=device))
    ctx.mark("weights")
    kw = trainer._render_kwargs()
    params = trainer.state.ema_params
    rng = np.random.default_rng(ctx.seed)
    order = rng.permutation(ds.n_views)

    def serve(v: int):
        img, depth = trainer._render_view(params, ds.eval_view(int(v)), ds, kw)
        return img.cpu(), depth.cpu()

    serve(order[-1])  # warm-up: this cell's one shape
    ctx.mark("warmup")
    frozen = scenes.load_arrays(root, t["split"])
    check = {"weights": weights, "root": root, "feats": feats, "poses": frozen["poses"],
             "intrinsics": frozen["intrinsics"], "H": ds.H, "W": ds.W, "slab": kw["slab"], "grid": grid, "rng": rng}
    return trainer, ds, serve, order, check


def run(ctx):
    from focnerf_tpu_torch.ops import kernel_wrappers
    from focnerf_tpu_torch.render import renderer

    trainer, ds, serve, order, check = setup(ctx)
    spans = tracing.Spans()
    stages = {}
    if ctx.trace:
        for name in ("march_rays", "color_fn"):
            stages[name] = getattr(renderer, name)
            setattr(renderer, name, spans.device_span(name, stages[name]))
    done, outputs, ends = [], [], []
    ctx.start_window()
    t0 = time.perf_counter()
    try:
        while not done or time.perf_counter() - t0 < ctx.seconds:
            v = int(order[len(done) % len(order)])
            outputs.append(serve(v))
            done.append(v)
            ends.append(time.perf_counter() - t0)
        window_s = time.perf_counter() - t0
        pixels = len(done) * ds.H * ds.W
        failed = sum(int(not (torch.isfinite(img).all() and torch.isfinite(d).all())) for img, d in outputs)
        result = {"metrics": {"render_rays_per_s": pixels / window_s}, "attempted": len(done), "failed": failed,
                  "window_s": window_s, "diag": {"view_ends_s": ends}}
        if ctx.trace:
            stage_s = {name: spans.device_total(name) for name in stages}
            for name, fn in stages.items():
                setattr(renderer, name, fn)
            stages.clear()
            before = {w.__name__: w.launches for w in kernel_wrappers()}
            with tracing.profiled(ctx.device) as prof:
                for i in range(ctx.traffic["trace_views"]):
                    serve(order[i % len(order)])
            result["trace"] = {
                "kind": "render", "window_s": window_s, "views": list(done), "stage_s": stage_s,
                "profile": prof.summary, "profiled_views": ctx.traffic["trace_views"], "rays_per_view": ds.H * ds.W,
                "launches": {w.__name__: w.launches - before[w.__name__] for w in kernel_wrappers()},
                "max_ray_batch": ctx.traffic["max_ray_batch"], "check": check,
            }
    finally:
        for name, fn in stages.items():
            setattr(renderer, name, fn)
    # the last finished view, and others drawn from the seed
    n_check = min(ctx.traffic["check_views"], len(done))
    picks = [len(done) - 1] + list(check["rng"].choice(len(done) - 1, n_check - 1, replace=False)) \
        if len(done) > 1 else [0]
    check["served"] = [(done[i], outputs[i]) for i in picks[:n_check]]
    del trainer, ds, serve, outputs
    result["check_data"] = check
    return result


def reference_views(ctx, check, dtype, views):
    """The reference's (image, depth, pixels whose ray meets an occupied
    cell) of views (pose indices)."""
    c, device = ctx.config, ctx.device
    grid = ref.layout_of(c)
    params = {k: v for k, v in check["weights"].items()}
    bits = ref.occupied_bits(check["grid"], c["density_thresh"])
    H, W = check["H"], check["W"]
    out = []
    with torch.no_grad():
        for v in views:
            pose = torch.from_numpy(check["poses"][v]).to(device)
            imgs, depths, hit = [], [], []
            for s in range(0, H * W, 1 << 17):
                inds = torch.arange(s, min(s + (1 << 17), H * W), device=device)
                o, d = ref.camera_rays(pose, check["intrinsics"], H, W, inds)
                r = ref.render_rays(params, c, grid, o, d, bits, check["feats"][v], dtype, slab=check["slab"], bg=1.0)
                imgs.append(r["image"])
                depths.append(r["depth"])
                hit.append(r["count"] > 0)
            out.append((torch.cat(imgs).reshape(H, W, 3).cpu(), torch.cat(depths).reshape(H, W).cpu(),
                        torch.cat(hit).reshape(H, W).cpu()))
    return out


def gaps(got, want) -> dict:
    """The numbers compared, over the pixels whose reference ray meets an
    occupied cell (the rest are background on both sides), worst checked
    view: the 99th percentile of a pixel's largest channel gap, and the mean
    depth gap. Not the mean image gap: the program's ladder takes its
    lattice in closed form (t_n * (1 + dt_gamma)^i) where the reference
    steps it, and a row of pixels whose lattice points lie within rounding
    of a cell face takes one sample more on one side, which moves the mean
    many times and leaves the 99th percentile where it is (PERF.md)."""
    def p99(a, b, hit):
        d = (a - b).abs().amax(-1)[hit] if bool(hit.any()) else (a - b).abs().amax(-1).flatten()
        return float(torch.quantile(d.double(), 0.99))

    def mean_gap(a, b, hit):
        return float((a - b).abs()[hit].mean()) if bool(hit.any()) else float((a - b).abs().mean())

    return {
        "image_p99_gap": max(p99(a[0], b[0], b[2]) for a, b in zip(got, want)),
        "depth_gap": max(mean_gap(a[1], b[1], b[2]) for a, b in zip(got, want)),
    }


def mean_image_gap(got, want) -> float:
    """The worst checked view's mean image gap over the hit pixels (reported, not compared)."""
    return max(float((a[0] - b[0]).abs()[b[2]].mean()) for a, b in zip(got, want))


def compare_outputs(ctx, check):
    views = [v for v, _ in check["served"]]
    want = reference_views(ctx, check, common.DTYPES[ctx.config["compute_dtype"]], views)
    return gaps([o for _, o in check["served"]], want)


def readings(ctx, check, control: bool) -> dict:
    """The program's gaps and, with ``control``, those of the reference in
    the next lower precision (fp8 for bf16), each against the reference."""
    views = [v for v, _ in check["served"]]
    want = reference_views(ctx, check, common.DTYPES[ctx.config["compute_dtype"]], views)
    got = [o for _, o in check["served"]]
    rows = {"program": gaps(got, want), "program_mean_image_gap": mean_image_gap(got, want)}
    if control:
        ctrl = reference_views(ctx, check, torch.float8_e4m3fn, views)
        rows["control"] = gaps(ctrl, want)
        rows["control_mean_image_gap"] = mean_image_gap(ctrl, want)
    return rows
