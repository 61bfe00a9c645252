"""Traffic generator ``train``: a per-object training job through ``Trainer.train``.

Set-up builds the CLI's trainer (``main_nerf``'s options from the traffic's
``cli``, the configuration's widths), loads the benchmark's seeded weights
into it, and drives it through its first ``check_steps`` + 1 steps with the
window's own call: ``Trainer.train`` for one fused chunk (training's first
occupancy refresh, then the chunk: its first step runs the chunk's step for
real while the CUDA graph is captured, the others are replays of that
graph). It records every random draw the trainer makes there, each step's
loss, the first gradient as Adam holds it after one step (its first moment
over 0.1) and each leaf's change after ``check_steps``. The window then
runs ``Trainer.train`` with ``steps_per_epoch`` = the train views, as
``main_nerf`` does, until ``--seconds`` have passed at an epoch's end. The
checkpoint the trainer saves after each epoch is replaced by that check:
nothing is written. After the window the trainer runs ``end_steps`` more
steps as one fused chunk, at the slab and on the grid that the window ended
with, keeping the state they started from, their draws and losses.

After the window, with the program freed, the plain reference follows the
first steps from the same weights and draws, and the end steps from the
program's own state (weights, Adam's moments, the occupancy grid: a
reference cannot rebuild thousands of steps), and the gaps between the two
decide ``correct`` (``gaps``).
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from portbench import common, scenes, tracing
from portbench.reference import nerf as ref


class _EndOfWindow(Exception):
    pass


def scene_for_reference(root: str, feats: torch.Tensor, device) -> dict:
    a = scenes.load_arrays(root, "train")
    rgba = torch.from_numpy(a["rgba"])
    V, H, W, _ = rgba.shape
    mask = rgba[..., 3] > 127
    rgb = (rgba[..., :3].float() / 255.0)
    pixels = torch.cat([rgb, mask[..., None].float()], -1).half()  # as -O preloads them
    return {"poses": torch.from_numpy(a["poses"]).to(device), "intrinsics": a["intrinsics"], "H": H, "W": W,
            "pixels": pixels.reshape(V, -1, 4).to(device), "masks": mask.reshape(V, -1).to(device),
            "feats": feats.to(device)}


def program_options(ctx, root: str):
    from focnerf_tpu_torch.config import parse_options

    c, t = ctx.config, ctx.traffic
    argv = [root, *t["cli"], "--workspace", os.path.join(ctx.workdir, "ws"), "--seed", str(ctx.seed),
            "--ckpt", "scratch", "--bound", str(c["bound"]), "--scale", str(t["scale"]),
            "--num_rays", str(t["num_rays"]), "--dt_gamma", str(c["dt_gamma"]), "--max_steps", str(c["max_steps"]),
            "--min_near", str(c["min_near"]), "--density_thresh", str(c["density_thresh"]),
            "--iters", str(c["iters"]), "--lr", str(c["lr"]), "--grid_levels", str(c["num_levels"]),
            "--grid_featdim", str(c["level_dim"])]
    return parse_options(argv)


def _cpu(x):
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_cpu(v) for v in x]
    return x.detach().cpu() if torch.is_tensor(x) else x


def _moments(state, key: str) -> list:
    """Adam's ``key`` moment of every leaf (zeros where it has none yet)."""
    from focnerf_tpu_torch.train.state import param_leaves

    return [state.optimizer.state.get(p, {}).get(key, torch.zeros_like(p)).detach().clone()
            for p in param_leaves(state.params)]


def fused_steps(trainer, ds, n: int, keep_after=()) -> dict:
    """``Trainer.train`` for one epoch of ``n`` steps, which must run as one
    fused chunk (the per-step path raises), recording every draw the
    trainer makes and, after step k in ``keep_after``, Adam's first moments
    and the parameters -> dict(draws, after: {k: (moments, params)})."""
    from focnerf_tpu_torch.train import trainer as trainer_mod
    from focnerf_tpu_torch.train.state import param_leaves

    drawn, after, chunks = [], {}, []
    keep = lambda d: drawn.append({k: v.clone() for k, v in d.items()}) or d  # noqa: E731
    step_draws, occ_draws, batch_draws = trainer_mod.step_draws, trainer_mod.occupancy_draws, ds.batch_draws
    chunk_fn = trainer._fused_chunk_fn

    def snapshot():
        return _moments(trainer.state, "exp_avg"), [p.detach().clone() for p in param_leaves(trainer.state.params)]

    def watched(d):
        chunk = chunk_fn(d)
        run, done = chunk.steps.run, [0]

        def run_and_keep(key, fn):
            run(key, fn)
            done[0] += 1
            if done[0] in keep_after:
                after[done[0]] = snapshot()

        chunk.steps.run = run_and_keep
        chunks.append(chunk)
        return chunk

    def per_step(batch):
        raise RuntimeError("a checked step took the per-step path, which the window does not run")

    trainer_mod.step_draws = lambda *a, **k: keep(step_draws(*a, **k))
    trainer_mod.occupancy_draws = lambda *a, **k: keep(occ_draws(*a, **k))
    ds.batch_draws = lambda g: keep(batch_draws(g))
    trainer._fused_chunk_fn, trainer._step = watched, per_step
    try:
        trainer.train(ds, None, max_epochs=1, steps_per_epoch=n)
    finally:
        trainer_mod.step_draws, trainer_mod.occupancy_draws = step_draws, occ_draws
        del ds.batch_draws, trainer._fused_chunk_fn, trainer._step
        for chunk in chunks:
            del chunk.steps.run
    if len(chunks) != 1:
        raise RuntimeError(f"the checked steps ran as {len(chunks)} fused chunks, not one")
    return {"draws": drawn, "after": after}


def _steps_of(drawn: list, n: int) -> list:
    """Per step, its batch draws (the view, the pixels) and its own draws;
    an occupancy refresh's draws, if any, come first."""
    drawn = drawn[len(drawn) - 2 * n:]
    return [{**drawn[2 * k], **drawn[2 * k + 1]} for k in range(n)]


def setup(ctx):
    """The trainer after its first steps, and what the check needs."""
    from focnerf_tpu_torch.apps.main_nerf import trainer_options
    from focnerf_tpu_torch.data.provider import NeRFDataset
    from focnerf_tpu_torch.train import trainer as trainer_mod
    from focnerf_tpu_torch.train.state import param_leaves

    device, c, t = ctx.device, ctx.config, ctx.traffic
    root = scenes.ensure_scene(t["scene"], device, ctx.cache)
    ctx.mark("scene")
    masks = scenes.load_arrays(root, "train")["rgba"][..., 3] > 127
    feats = common.seeded_features(len(masks), c["yolo_feats_dim"], ctx.seed, device)
    opt = program_options(ctx, root)
    ds = NeRFDataset(opt.dataset_options(), split="train", detected_object="object", device=device,
                     mask_details={"masks": masks, "feats": feats.cpu().numpy(), "paths": None})
    ctx.mark("scene_read")
    cfg = common.program_config(c, opt.nerf_config())
    trainer = trainer_mod.Trainer("ngp", cfg, workspace=opt.workspace, device=device, **trainer_options(opt))
    ctx.mark("trainer")
    weights = common.seeded_weights(c, ctx.seed, device)
    common.load_into(param_leaves(trainer.state.params), weights)
    common.load_into(param_leaves(trainer.state.ema_params), weights)
    ctx.mark("weights")

    stop = {"at": None}

    def end_of_epoch():  # stands where the trainer saves its checkpoint
        if stop["at"] is not None and stop["at"]():
            raise _EndOfWindow

    trainer.save_checkpoint = end_of_epoch

    n = t["check_steps"]
    rec = fused_steps(trainer, ds, n + 1, keep_after=(1, n))
    with torch.no_grad():
        g1 = [float((m / 0.1).norm()) for m in rec["after"][1][0]]
        dp = [float((p - q).norm()) for p, q in zip(rec["after"][n][1], ref.leaves(weights))]
    outputs = {"losses": list(trainer.step_losses[:n]), "g1": g1, "dp": dp,
               "density": trainer.occupancy.density_grid.cpu()}
    check = {"weights": _cpu(weights), "jitter": rec["draws"][0]["jitter"].cpu(), "bits": first_bits(trainer),
             "steps": _cpu(_steps_of(rec["draws"], n + 1)[:n]), "feats": feats.cpu(), "root": root,
             "outputs": outputs, "slab": trainer.active_slab}
    return trainer, ds, stop, check


def first_bits(trainer) -> torch.Tensor:
    """The cells the first steps march through: the program's grid after
    its first refresh. At the table's init every seen cell's density is 1
    to within 1e-4 and the threshold is their mean, so which cells pass it
    is decided by rounding; the reference marches the program's cells and
    holds the refresh's densities to its own (``grid_gap``)."""
    from focnerf_tpu_torch.ops.occupancy import occupancy_bitfield

    return occupancy_bitfield(trainer.occupancy, trainer.density_thresh).cpu()


def end_steps(trainer, ds, n: int) -> dict:
    """``n`` steps as one fused chunk at the state the window left, and
    what the reference needs to follow them from there."""
    from focnerf_tpu_torch.ops.occupancy import occupancy_bitfield
    from focnerf_tpu_torch.train.state import param_leaves

    iv = trainer.update_extra_interval
    to_tick = (-trainer.global_step) % iv
    if 0 < to_tick < n:  # a chunk never crosses a refresh: go to it, unchecked
        trainer.train(ds, None, max_epochs=1, steps_per_epoch=to_tick)
    st = trainer.state
    leaves = param_leaves(st.params)
    start = {"params": [p.detach().clone() for p in leaves], "m": _moments(st, "exp_avg"),
             "v": _moments(st, "exp_avg_sq"), "k": st.adam_count}
    rec = fused_steps(trainer, ds, n)
    with torch.no_grad():
        dp = [float((p - q).norm()) for p, q in zip(leaves, start["params"])]
    return _cpu({"start": start, "steps": _steps_of(rec["draws"], n), "slab": trainer.active_slab,
                 "bits": occupancy_bitfield(trainer.occupancy, trainer.density_thresh),
                 "outputs": {"losses": list(trainer.step_losses[-n:]), "dp": dp}})


@torch.no_grad()
def table_stats(trainer) -> dict:
    """The hash table's entries that training moved off their init: their
    share and root mean square (what a trained object's table holds)."""
    table = trainer.state.params["grid"]
    moved = table.abs() > common.TABLE_INIT
    return {"table_moved_share": float(moved.float().mean()),
            "table_rms_moved": float(table[moved].double().square().mean().sqrt()) if bool(moved.any()) else 0.0}


def run(ctx):
    from focnerf_tpu_torch.ops import kernel_wrappers
    from focnerf_tpu_torch.ops.occupancy import occupancy_bitfield

    trainer, ds, stop, check = setup(ctx)
    rays_per_step = min(ctx.traffic["num_rays"], ds.H * ds.W)
    spans = tracing.Spans()
    if ctx.trace:
        update = trainer._maybe_update_occupancy

        def timed_update():
            if trainer.global_step % trainer.update_extra_interval:
                return update()
            with spans.span("occupancy", sync=True):
                return update()

        trainer._maybe_update_occupancy = timed_update
    bits_start = occupancy_bitfield(trainer.occupancy, trainer.density_thresh).clone() if ctx.trace else None
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    ctx.start_window()
    t0, gs0 = time.perf_counter(), trainer.global_step

    ends = []

    def closed():
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
        ends.append((trainer.global_step - gs0, time.perf_counter() - t0))
        return ends[-1][1] >= ctx.seconds

    stop["at"] = closed
    with contextlib.suppress(_EndOfWindow):
        trainer.train(ds, None, max_epochs=10**9, steps_per_epoch=ds.n_views)
    window_s = time.perf_counter() - t0
    steps = trainer.global_step - gs0
    losses = torch.tensor(trainer.step_losses[-steps:])
    result = {
        "metrics": {"train_rays_per_s": steps * rays_per_step / window_s},
        "attempted": steps, "failed": int((~torch.isfinite(losses)).sum()), "window_s": window_s,
        "diag": {"epoch_ends": ends, "slab": trainer.active_slab, **table_stats(trainer)},
    }
    if ctx.trace:
        occ_s = spans.total("occupancy")
        del trainer._maybe_update_occupancy  # the span's syncs stay out of the profiled epochs
        slabs = []
        run_chunk, one_step = trainer._run_fused_chunk, trainer._step
        trainer._run_fused_chunk = lambda d, n: (slabs.append((n, trainer.active_slab)), run_chunk(d, n))[1]
        trainer._step = lambda b: (slabs.append((1, trainer.active_slab)), one_step(b))[1]
        before = {w.__name__: w.launches for w in kernel_wrappers()}
        epochs, gs1 = {"n": 0}, trainer.global_step

        def traced_epochs():
            epochs["n"] += 1
            return epochs["n"] >= ctx.traffic["trace_epochs"]

        stop["at"] = traced_epochs
        with tracing.profiled(ctx.device) as prof, contextlib.suppress(_EndOfWindow):
            trainer.train(ds, None, max_epochs=10**9, steps_per_epoch=ds.n_views)
        del trainer._run_fused_chunk, trainer._step
        launches = {w.__name__: w.launches - before[w.__name__] for w in kernel_wrappers()}
        bits_end = occupancy_bitfield(trainer.occupancy, trainer.density_thresh)
        # the window's own step time over its last epochs (up to two), untraced
        last = ends[-3] if len(ends) >= 3 else (0, 0.0)
        result["trace"] = {
            "kind": "train", "window_s": window_s, "steps": steps, "rays_per_step": rays_per_step,
            "occupancy_s": occ_s, "profile": prof.summary, "launches": launches, "slabs": slabs,
            "bits": [bits_start, bits_end], "check": check, "traced_steps": trainer.global_step - gs1,
            "untraced_step_s": (ends[-1][1] - last[1]) / max(ends[-1][0] - last[0], 1),
        }
    stop["at"] = None
    check["end"] = end_steps(trainer, ds, ctx.traffic["end_steps"])
    del trainer, ds
    result["check_data"] = check
    return result


def _follow(ctx, scene, params, adam, bits, steps, slab, dtype, half: bool):
    """The reference through ``steps`` from ``params`` -> (losses, the
    first step's gradient norms)."""
    grid = ref.layout_of(ctx.config)
    device = ctx.device
    losses, g1 = [], None
    for s in steps:
        s = {k: v.to(device) for k, v in s.items()}
        inds = s["inds"]
        draws = {"bg": s["bg"], "noise": s["noise"], "u": s["u"]}
        if half:
            n = inds.shape[0] // 2
            inds = inds[:n]
            draws = {"bg": draws["bg"][:n], "noise": draws["noise"][:n], "u": draws["u"][:n * slab]}
        batch = ref.batch_of(scene, int(s["view"]), inds, device)
        loss, _ = ref.train_loss(params, ctx.config, grid, batch, bits, draws, dtype, slab)
        loss.backward()
        if g1 is None:
            g1 = [float(p.grad.norm()) for p in ref.leaves(params)]
        adam.step()
        losses.append(float(loss.detach()))
    return losses, g1


def reference_outputs(ctx, check, dtype, half: bool = False, own_grid: bool = False):
    """The reference's first density grid, and its losses, first gradient
    and leaf changes over the checked steps, from the benchmark's weights
    and the trainer's draws, marching the program's first cells (its own
    with ``own_grid``); ``half`` leaves out the second half of every batch
    (a planted fault)."""
    c, device = ctx.config, ctx.device
    scene = scene_for_reference(check["root"], check["feats"], device)
    grid = ref.layout_of(c)
    w0 = {k: ([w.to(device) for w in v] if isinstance(v, list) else v.to(device)) for k, v in check["weights"].items()}
    params = ref.clone(w0, requires_grad=True)
    density, bits = ref.first_occupancy(params, c, grid, scene["poses"], scene["intrinsics"],
                                        check["jitter"].to(device), dtype)
    out = {"density": density.cpu(), "bits_differ": int((bits.cpu() != check["bits"]).sum())}
    if not own_grid:
        bits = check["bits"].to(device)
    losses, g1 = _follow(ctx, scene, params, ref.Adam(params, c["lr"], c["iters"]), bits, check["steps"],
                         check["slab"], dtype, half)
    with torch.no_grad():
        dp = [float((p - q).norm()) for p, q in zip(ref.leaves(params), ref.leaves(w0))]
    out.update(losses=losses, g1=g1, dp=dp)

    # the end steps, from the program's state at the window's end
    end = check["end"]
    start = end["start"]
    p0 = [p.to(device) for p in start["params"]]
    params = ref.clone(_like(w0, p0), requires_grad=True)
    adam = ref.Adam(params, c["lr"], c["iters"], moments=([m.to(device) for m in start["m"]],
                                                          [v.to(device) for v in start["v"]]), k=start["k"])
    losses, g1 = _follow(ctx, scene, params, adam, end["bits"].to(device), end["steps"], end["slab"], dtype, half)
    with torch.no_grad():
        dp = [float((p - q).norm()) for p, q in zip(ref.leaves(params), p0)]
    out["end"] = {"losses": losses, "g1": g1, "dp": dp}
    return out


def _like(params: dict, flat: list) -> dict:
    """``flat`` leaves in the layout of ``params`` (``ref.leaves``' order)."""
    out, i = {}, 0
    for k, v in params.items():
        if isinstance(v, list):
            out[k] = flat[i:i + len(v)]
            i += len(v)
        else:
            out[k] = flat[i]
            i += 1
    return out


def _loss_gap(got, want) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))


def _update_gap(got, want) -> float:
    """Leaves whose reference gradient is under a thousandth of the median
    leaf's move by round-off alone under Adam and are left out."""
    med = float(np.median(want["g1"]))
    return common.norm_gap(got["dp"], want["dp"], [g >= 1e-3 * med for g in want["g1"]])


def _grid_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The first refresh: the worst cell's density gap over the median seen
    cell's density (cells no camera sees are -1 on both sides)."""
    return float((got - want).abs().max() / want[want >= 0].median())


def gaps(got, want) -> dict:
    """The numbers compared: the first refresh's density grid; over the
    first checked steps, every step's relative loss gap (the largest), and
    by the worst leaf the gaps of the first gradient's norm and of the norm
    of each leaf's change; over the end steps, the change's gap. The end
    steps' losses are reported, not compared: on the window's sparse grid
    the program's skip walk lands its leaps by a closed form that rounds
    off the stepped lattice, a ray near a cell face takes a sample more or
    fewer, and sound runs read up to 7e-3, the control 1.8e-2 (PERF.md)."""
    return {
        "grid_gap": _grid_gap(got["density"], want["density"]),
        "loss_gap": _loss_gap(got, want),
        "grad_gap": common.norm_gap(got["g1"], want["g1"]),
        "update_gap": _update_gap(got, want),
        "end_update_gap": _update_gap(got["end"], want["end"]),
    }


def _program(check) -> dict:
    return {**check["outputs"], "end": check["end"]["outputs"]}


def step_loss_gaps(got, want) -> list:
    """Every checked step's relative loss gap, the first steps' then the end's (reported)."""
    return [abs(a - b) / abs(b) for g, w in ((got, want), (got["end"], want["end"]))
            for a, b in zip(g["losses"], w["losses"])]


def compare_outputs(ctx, check):
    want = reference_outputs(ctx, check, common.DTYPES[ctx.config["compute_dtype"]])
    return gaps(_program(check), want)


def readings(ctx, check, control: bool) -> dict:
    """The program's gaps (and its step losses' gaps against the reference
    marching its own first grid, with the cells the two grids differ in)
    and, with ``control``, those of the reference in the next lower
    precision (fp8 for bf16) and of a planted fault (half of every batch
    left out), each against the reference."""
    want = reference_outputs(ctx, check, common.DTYPES[ctx.config["compute_dtype"]])
    got = _program(check)
    own = reference_outputs(ctx, check, common.DTYPES[ctx.config["compute_dtype"]], own_grid=True)
    rows = {"program": gaps(got, want), "program_step_loss_gaps": step_loss_gaps(got, want),
            "own_grid_step_loss_gaps": step_loss_gaps(got, own), "first_bits_differ": want["bits_differ"],
            "end_slab": check["end"]["slab"]}
    if control:
        rows["control"] = gaps(reference_outputs(ctx, check, torch.float8_e4m3fn), want)
        rows["half_batch"] = gaps(reference_outputs(ctx, check, common.DTYPES[ctx.config["compute_dtype"]],
                                                    half=True), want)
    return rows
