"""Dense voxel fields trained through the differentiable shear-warp renderer.

Twin of focnerf_tpu/train/voxel.py. The scene is a dense RGBA(+SH) voxel
grid of raw parameters (sigma = softplus(raw_sigma), diffuse colour =
sigmoid(raw_rgb), SH coefficients linear), optimized by whole-image descent
through ``render/baked.py``'s compositor: batched slice resamples, a
log-space fold, all dense, no per-sample random access.

One engine, ``_fit_field_loop``, trains every family (dense here; VM,
low-rank dynamic and K-planes in the sibling modules): a family is a
``raw_fn`` that collapses its parameters (at the view's time) to the dense
raw grid and a ``reg_fn``. GTs are pre-warped once per view onto the
intermediate plane (``supervise="intermediate"``, the default) so the
screen warp never enters the step; ``"screen"`` supervises the full render.
The optimizer is ``torch.optim.Adam`` with optax.adam's settings (eps 1e-8,
no weight decay), and the shuffled view order is JAX's
(``np.random.default_rng(seed).integers(0, V, iters)``), so both packages
visit the same views.

Precision follows the device, as the renderer's does: fp32 on the CPU; on
the card the resample operands are rounded to bf16 and multiplied as fp32
products (``_make_loss(compute_dtype=)`` overrides it, e.g. fp32 to check
the card against the CPU).
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from focnerf_tpu_torch.render.baked import BakedVolume


def payload_channels(sh_degree: int) -> int:
    """Payload channels of a field: rgb, or 3 * sh_degree^2 SH coefficients."""
    return 3 * max(sh_degree, 1) ** 2 if sh_degree > 0 else 3


def init_voxel_field(
    resolution: int,
    sh_degree: int = 0,
    raw_sigma0: float = -3.0,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> torch.Tensor:
    """Raw field [R, R, R, P+1] (payload channels then sigma) on ``device``
    (None: ``cuda``). raw_sigma0 = -3 starts the volume nearly transparent;
    with a CPU ``generator``, 0.01 N(0, 1) colour noise breaks the sigmoid
    symmetry."""
    from focnerf_tpu_torch import resolve_device

    P = payload_channels(sh_degree)
    raw = torch.zeros((resolution,) * 3 + (P + 1,), dtype=torch.float32)
    raw[..., -1] = raw_sigma0
    if generator is not None:
        raw[..., :P] += 0.01 * torch.randn(raw[..., :P].shape, generator=generator)
    return raw.to(resolve_device(device))


def field_to_volume(raw: torch.Tensor, bound: float, sh_degree: int = 0) -> BakedVolume:
    """Activation: raw parameters -> renderable BakedVolume."""
    payload = raw[..., :-1] if sh_degree > 0 else torch.sigmoid(raw[..., :-1])
    sigma = F.softplus(raw[..., -1:])
    return BakedVolume(rgba=torch.cat([payload, sigma], -1), bound=bound, sh_deg=sh_degree)


def tv_loss(raw: torch.Tensor) -> torch.Tensor:
    """Mean 3D total variation of the raw field (all channels)."""
    tv = 0.0
    for ax in range(3):
        d = torch.diff(raw, dim=ax)
        tv = tv + torch.mean(d * d)
    return tv


def _pose_variant(pose: np.ndarray, bound: float) -> Tuple[int, bool]:
    """Mirror render_baked's host-side principal-axis choice (baked.py)."""
    fwd = pose[:3, :3] @ np.array([0.0, 0.0, 1.0], np.float32)
    axis = int(np.argmax(np.abs(fwd)))
    eye = pose[:3, 3]
    if abs(eye[axis]) <= bound:
        axis = int(np.argmax(np.abs(eye)))
    return axis, bool(pose[axis, 3] < 0)


def _leaves(params):
    return [params] if torch.is_tensor(params) else list(params)


def _rebuild(params, leaves):
    return leaves[0] if torch.is_tensor(params) else type(params)(*leaves)


class FieldState:
    """A family's trainable tensors (copies of ``params``' leaves) and their
    ``torch.optim.Adam`` with optax.adam's settings (eps 1e-8, no weight
    decay); the optimizer updates the leaves in place. ``capturable`` keeps
    Adam's step count on the device, as a CUDA graph needs."""

    def __init__(self, params, lr: float, capturable: bool = False):
        self._template = params
        self.leaves = [p.detach().clone().requires_grad_(True) for p in _leaves(params)]
        self.optimizer = torch.optim.Adam(self.leaves, lr=lr, eps=1e-8, capturable=capturable)

    @property
    def params(self):
        return _rebuild(self._template, self.leaves)

    def detached(self):
        return _rebuild(self._template, [p.detach() for p in self.leaves])


def _make_loss(
    axis: int,
    flip: bool,
    *,
    raw_fn,
    reg_fn,
    bound: float,
    sh_degree: int,
    ri: int,
    bg_color: float,
    density_scale: float,
    remat: bool,
    supervise: str,
    intr=None,  # [4] tensor, the screen loss only
    H: int = 0,
    W: int = 0,
    compute_dtype=None,
):
    """The loss of one (axis, flip) variant: loss_fn(params, pose [4, 4]
    tensor, t, target, mask) -> (mse + reg, mse). ``target``/``mask`` are the
    pre-warped GT [ri, ri, 3] and its valid-ray mask [ri, ri]
    (intermediate), or the image [H, W, 3] and an ignored mask (screen).
    Training renders a float volume: the uint8 ``quant`` path is never
    reached from here."""
    from focnerf_tpu_torch.render.baked import _composite_core, _render_core

    if supervise == "intermediate":

        def loss_fn(params, pose, t, wgt, mask):
            vol = field_to_volume(raw_fn(params, t), bound, sh_degree)
            C, T, _, _ = _composite_core(
                vol.rgba, bound, pose, axis=axis, flip=flip, ri=ri, density_scale=density_scale,
                sh_deg=sh_degree, quant=None, compute_dtype=compute_dtype, remat=remat, with_depth=False,
            )
            img_i = C + T[..., None] * bg_color
            m = mask[..., None]
            mse = torch.sum(m * (img_i - wgt) ** 2) / (3.0 * torch.clamp(torch.sum(mask), min=1.0))
            return mse + reg_fn(params), mse

    elif supervise == "screen":

        def loss_fn(params, pose, t, gt, mask):
            vol = field_to_volume(raw_fn(params, t), bound, sh_degree)
            img, _, _ = _render_core(
                vol.rgba, bound, pose, intr, axis=axis, flip=flip, H=H, W=W, ri=ri, bg_color=bg_color,
                density_scale=density_scale, sh_deg=sh_degree, quant=None, compute_dtype=compute_dtype,
                remat=remat,
            )
            mse = torch.mean((img - gt) ** 2)
            return mse + reg_fn(params), mse

    else:
        raise ValueError(f"supervise must be 'intermediate' or 'screen', not {supervise!r}")
    return loss_fn


def _fit_field_loop(
    poses: np.ndarray,  # [V, 4, 4] c2w
    images,  # [V, H, W, 3] in [0, 1], numpy or tensor
    intrinsics: Sequence[float],  # fx, fy, cx, cy
    *,
    params,  # initial parameters of the family: a tensor or a NamedTuple of tensors
    raw_fn,  # (params, t) -> raw grid [R, R, R, C] (t ignored when static)
    reg_fn,  # params -> scalar regularizer
    resolution: int,
    bound: float = 1.0,
    sh_degree: int = 0,
    iters: int = 500,
    lr: float = 5e-2,
    bg_color: float = 1.0,
    density_scale: float = 1.0,
    seed: int = 0,
    log_every: int = 0,
    intermediate_scale: int = 2,
    remat: bool = True,
    supervise: str = "intermediate",
    times: Optional[np.ndarray] = None,  # [V] per-view scalars fed to raw_fn
    tag: str = "voxel",
    steps_per_dispatch: int = 1,
) -> Tuple[object, Dict]:
    """Shared whole-image descent engine of every voxel family, on the
    params' device: one loss per (axis, flip) variant, GTs pre-warped once
    per view (intermediate supervision), JAX's shuffled view order.

    ``steps_per_dispatch`` K > 1 (with ``iters`` >= K) is JAX's fused
    dispatch (a scan over a switch of the variants' steps): the same
    schedule in chunks of K steps, each step reading its view from a
    [K] buffer of view ids through a slot counter on the device
    (train/fused.py's ``GraphedSteps``); on the card each (axis, flip)
    variant's step is captured once into a CUDA graph and the chunk replays
    them in schedule order. The views' targets are warped up front, the
    view's time enters as a 0-d tensor, Adam is ``capturable``. On the CPU
    the chunk is that loop and equals the per-step one bit for bit.

    Returns (params, info) with info = {"psnr" of the last step,
    "rays_per_sec" (supervised rays), "seconds", "step_mse" [iters]}."""
    from focnerf_tpu_torch.render.baked import warp_gt_to_intermediate

    K = max(1, int(steps_per_dispatch))
    fused = K > 1 and iters >= K
    device = _leaves(params)[0].device
    state = FieldState(params, lr, capturable=fused and device.type == "cuda")
    V = len(poses)
    poses = np.asarray(poses, np.float32)
    gts = torch.as_tensor(images, dtype=torch.float32).to(device)
    H, W = int(gts.shape[1]), int(gts.shape[2])
    intr = torch.as_tensor(np.asarray(intrinsics, np.float32), device=device)
    poses_dev = torch.as_tensor(poses, device=device)
    ri = resolution * intermediate_scale
    t_arr = np.zeros(V, np.float32) if times is None else np.asarray(times, np.float32)

    optimizer = state.optimizer
    losses: Dict[Tuple[int, bool], object] = {}
    targets: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
    loss_kw = dict(raw_fn=raw_fn, reg_fn=reg_fn, bound=bound, sh_degree=sh_degree, ri=ri, bg_color=bg_color,
                   density_scale=density_scale, remat=remat, supervise=supervise, intr=intr, H=H, W=W)

    def targets_for(v: int, key: Tuple[int, bool]):
        if supervise == "screen":
            return gts[v], torch.ones((1, 1), device=device)
        if v not in targets:
            targets[v] = warp_gt_to_intermediate(gts[v], poses[v], intr, bound, axis=key[0], flip=key[1], ri=ri)
        return targets[v]

    order = np.random.default_rng(seed).integers(0, V, iters)
    mses = []
    t0 = time.time()
    if fused:
        mses = _fused_field_steps(state, order, K, poses, poses_dev, t_arr, losses, loss_kw, targets_for,
                                  bound=bound, log_every=log_every, tag=tag)
    else:
        for it in range(iters):
            v = int(order[it])
            key = _pose_variant(poses[v], bound)
            if key not in losses:
                losses[key] = _make_loss(*key, **loss_kw)
            target, mask = targets_for(v, key)
            optimizer.zero_grad(set_to_none=True)
            loss, mse = losses[key](state.params, poses_dev[v], float(t_arr[v]), target, mask)
            loss.backward()
            optimizer.step()
            mses.append(mse.detach())
            if log_every and (it + 1) % log_every == 0:
                print(f"[{tag}] iter {it + 1}/{iters} mse {float(mses[-1]):.5f}", flush=True)
    step_mse = torch.cat([m.reshape(-1) for m in mses]).cpu().numpy() if mses else np.ones(1, np.float32)
    dt = time.time() - t0
    n_sup = ri * ri if supervise == "intermediate" else H * W
    info = {
        "psnr": -10.0 * float(np.log10(max(float(step_mse[-1]), 1e-10))),
        "rays_per_sec": n_sup * iters / dt,
        "seconds": dt,
        "step_mse": step_mse,
    }
    return state.detached(), info


def _fused_field_steps(state: FieldState, order, K: int, poses, poses_dev, t_arr, losses, loss_kw, targets_for,
                       *, bound: float, log_every: int, tag: str):
    """The schedule ``order`` in chunks of K steps (``_fit_field_loop``'s
    fused dispatch) -> the steps' mse, a list of [n] device tensors."""
    from focnerf_tpu_torch.train.fused import GraphedSteps

    device = poses_dev.device
    V = len(poses)
    variant = [_pose_variant(poses[v], bound) for v in range(V)]
    for key in sorted(set(variant)):
        if key not in losses:
            losses[key] = _make_loss(*key, **loss_kw)
    warped = [targets_for(v, variant[v]) for v in range(V)]
    targets = torch.stack([w for w, _ in warped])
    masks = torch.stack([m for _, m in warped])
    t_dev = torch.as_tensor(t_arr, device=device)
    steps = GraphedSteps(device)
    ids = torch.zeros((K,), dtype=torch.int64, device=device)
    mse_buf = torch.zeros((K,), device=device)
    optimizer = state.optimizer

    def body(key):
        slot = steps.slot
        vid = ids.index_select(0, slot)
        optimizer.zero_grad(set_to_none=True)
        loss, mse = losses[key](state.params, poses_dev.index_select(0, vid)[0], t_dev.index_select(0, vid)[0],
                                targets.index_select(0, vid)[0], masks.index_select(0, vid)[0])
        loss.backward()
        optimizer.step()
        mse_buf.index_copy_(0, slot, mse.detach().reshape(1))
        slot.add_(1)

    mses = []
    it = 0
    while it < len(order):
        n = min(K, len(order) - it)
        chunk = torch.as_tensor(np.asarray(order[it : it + n], np.int64))
        ids[:n].copy_(chunk.pin_memory() if device.type == "cuda" else chunk, non_blocking=True)
        steps.start()
        for v in order[it : it + n]:
            key = variant[int(v)]
            steps.run(key, lambda key=key: body(key))
        mses.append(mse_buf[:n].clone())
        it += n
        if log_every and (it % log_every) < n:
            print(f"[{tag}] iter {it}/{len(order)} mse {float(mses[-1][-1]):.5f}", flush=True)
    if device.type == "cuda":
        print(f"[{tag}] fused dispatch: {len(order)} steps in chunks of {K}, {steps.captures} graphs "
              f"captured, {steps.replays} replays", flush=True)
    return mses


def _c2f_stage_plan(resolution: int, stages: int, iters: int):
    """Coarse-to-fine ladder shared by the families: resolution doubles each
    stage up to ``resolution`` (floored at 16), ``iters`` split evenly with
    the final stage taking the remainder, each stage at least 1 step.

    Returns [(stage_resolution, stage_iters), ...]."""
    if stages < 1:
        raise ValueError(f"c2f needs at least one stage, got {stages}")
    ladder = [max(resolution >> (stages - 1 - s), 16) for s in range(stages)]
    ladder = sorted(set(min(r, resolution) for r in ladder))
    if ladder[-1] != resolution:
        ladder.append(resolution)
    per = max(iters // len(ladder), 1)
    counts = [per] * (len(ladder) - 1) + [max(iters - per * (len(ladder) - 1), 1)]
    return list(zip(ladder, counts))


def fit_voxels(
    poses: np.ndarray,
    images,
    intrinsics: Sequence[float],
    *,
    resolution: int = 128,
    bound: float = 1.0,
    sh_degree: int = 0,
    iters: int = 500,
    lr: float = 5e-2,
    tv_weight: float = 1e-4,
    bg_color: float = 1.0,
    density_scale: float = 1.0,
    init_raw: Optional[torch.Tensor] = None,
    seed: int = 0,
    log_every: int = 0,
    intermediate_scale: int = 2,
    remat: bool = True,
    supervise: str = "intermediate",
    steps_per_dispatch: int = 1,
    device=None,
) -> Tuple[BakedVolume, Dict]:
    """Fit a dense voxel field to posed images by whole-image descent, on
    ``init_raw``'s device or ``device`` (None: ``cuda``); a fresh field draws
    its colour noise from ``torch.Generator().manual_seed(seed)``.

    Returns (volume, info); info["raw"] is the pre-activation field."""
    raw = init_raw
    if raw is None:
        raw = init_voxel_field(resolution, sh_degree, generator=torch.Generator().manual_seed(seed), device=device)
    raw, info = _fit_field_loop(
        poses, images, intrinsics,
        params=raw,
        raw_fn=lambda raw, t: raw,  # the dense field is the raw grid
        reg_fn=lambda raw: tv_weight * tv_loss(raw),
        resolution=resolution, bound=bound, sh_degree=sh_degree, iters=iters, lr=lr, bg_color=bg_color,
        density_scale=density_scale, seed=seed, log_every=log_every, intermediate_scale=intermediate_scale,
        remat=remat, supervise=supervise, tag="voxel", steps_per_dispatch=steps_per_dispatch,
    )
    info["raw"] = raw
    return field_to_volume(raw, bound, sh_degree), info


def upsample_field(raw: torch.Tensor, new_res: int) -> torch.Tensor:
    """Trilinearly upsample a raw field [R, R, R, C] -> [new_res]^3 x C, as
    ``jax.image.resize(..., "trilinear")`` does: half-pixel centres, the
    edge taps renormalized (align_corners=False clamps to the same)."""
    x = raw.permute(3, 0, 1, 2)[None]
    out = F.interpolate(x, size=(new_res,) * 3, mode="trilinear", align_corners=False)
    return out[0].permute(1, 2, 3, 0).contiguous()


def fit_voxels_c2f(
    poses: np.ndarray,
    images,
    intrinsics: Sequence[float],
    *,
    resolution: int = 128,
    stages: int = 3,
    iters: int = 500,
    seed: int = 0,
    log_every: int = 0,
    **kw,
) -> Tuple[BakedVolume, Dict]:
    """Coarse-to-fine fit on ``_c2f_stage_plan``'s ladder, each stage seeded
    with the upsampled previous field (stage s draws with seed + s).
    Returns the final stage's (volume, info), with info["stage_psnrs"] each
    stage's closing train PSNR and info["step_mse"] every stage's steps."""
    raw = None
    stage_psnrs, step_mse = [], []
    info: Dict = {}
    vol = None
    for si, (R, n_it) in enumerate(_c2f_stage_plan(resolution, stages, iters)):
        if raw is not None:
            raw = upsample_field(raw, R)
        vol, info = fit_voxels(poses, images, intrinsics, resolution=R, iters=n_it, init_raw=raw, seed=seed + si,
                               log_every=log_every, **kw)
        stage_psnrs.append(info["psnr"])
        step_mse.append(info["step_mse"])
        raw = info["raw"]
    info["stage_psnrs"] = stage_psnrs
    info["step_mse"] = np.concatenate(step_mse)
    return vol, info


def _volume_to_raw(vol: BakedVolume, sh_degree: int = 0) -> torch.Tensor:
    """Invert field_to_volume (logit of the payload clipped to [1e-6,
    1 - 1e-6]; softplus^-1 of sigma floored at 1e-6)."""
    payload = vol.rgba[..., :-1]
    sigma = vol.rgba[..., -1:]
    if sh_degree > 0:
        raw_payload = payload  # linear
    else:
        p = torch.clamp(payload, 1e-6, 1.0 - 1e-6)
        raw_payload = torch.log(p) - torch.log1p(-p)
    s = torch.clamp(sigma, min=1e-6)
    raw_sigma = s + torch.log(-torch.expm1(-s))  # softplus^-1(y) = y + log(1 - exp(-y))
    return torch.cat([raw_payload, raw_sigma], -1)


def make_voxel_dp_step(
    mesh,
    intrinsics: Sequence[float],
    *,
    H: int,
    W: int,
    resolution: int,
    warp_axis: int,
    flip: bool,
    bound: float = 1.0,
    sh_degree: int = 0,
    lr: float = 5e-2,
    tv_weight: float = 1e-4,
    bg_color: float = 1.0,
    density_scale: float = 1.0,
    axis: str = "data",
    intermediate_scale: int = 2,
    remat: bool = True,
    supervise: str = "intermediate",
    collapse_fn=None,
    reg_fn=None,
    time_conditioned: bool = False,
):
    """Pose-parallel voxel train step over a mesh axis (JAX's
    ``make_voxel_dp_step``): every rank passes the same global batch of D
    views of one (warp_axis, flip) variant, renders and differentiates its
    D/W of them against their targets, the gradient is averaged over the
    ranks (one all-reduce), and every rank takes the same Adam step on its
    replica of the params.

    ``supervise`` as ``fit_voxels``: "intermediate" takes pre-warped targets
    [D, ri, ri, 3] and masks [D, ri, ri], "screen" images [D, H, W, 3]
    (masks ignored). ``collapse_fn``/``reg_fn`` give a factorized family:
    params -> raw grid (or (params, t) -> raw grid with
    ``time_conditioned``, collapsed at each view's own time) and params ->
    regularizer (defaults: the dense field itself, ``tv_weight`` * TV).

    Returns (init, step): ``init(params)`` -> ``FieldState``;
    ``step(state, poses [D, 4, 4][, times [D]], targets, masks)`` -> the
    mean mse over the D views (a device scalar, alike on every rank)."""
    from focnerf_tpu_torch.parallel.collectives import all_mean, mean_gradients

    if time_conditioned and collapse_fn is None:
        raise ValueError("time_conditioned=True requires a collapse_fn(params, t): the dense default "
                         "collapse takes no time (see make_kplanes_dp_step / make_dyn_dp_step)")
    if collapse_fn is None:
        collapse_fn = lambda p: p  # noqa: E731 - the dense field is the raw grid
    if reg_fn is None:
        reg_fn = lambda p: tv_weight * tv_loss(p)  # noqa: E731
    raw_fn = collapse_fn if time_conditioned else (lambda raw, t: raw)
    group = mesh.get_group(axis)
    rank, world = mesh.get_local_rank(axis), mesh.size(mesh.mesh_dim_names.index(axis))
    intr = np.asarray(intrinsics, np.float32)
    ri = resolution * intermediate_scale

    def init(params) -> FieldState:
        return FieldState(params, lr)

    def run(state: FieldState, poses, times, targets, masks):
        D = len(poses)
        if D % world:
            raise ValueError(f"{D} views do not divide over {world} ranks")
        device = state.leaves[0].device
        loss_fn = _make_loss(
            warp_axis, flip, raw_fn=raw_fn, reg_fn=lambda p: 0.0, bound=bound, sh_degree=sh_degree, ri=ri,
            bg_color=bg_color, density_scale=density_scale, remat=remat, supervise=supervise,
            intr=torch.as_tensor(intr, device=device), H=H, W=W,
        )
        poses = torch.as_tensor(np.asarray(poses, np.float32), device=device)
        per = D // world
        state.optimizer.zero_grad(set_to_none=True)
        params = state.params
        base = params if time_conditioned else collapse_fn(params)
        mses = [loss_fn(base, poses[v], float(times[v]), targets[v], masks[v])[1]
                for v in range(rank * per, (rank + 1) * per)]
        mse = torch.stack(mses).mean()
        (mse + reg_fn(params)).backward()
        mean_gradients(state.leaves, group)
        state.optimizer.step()
        return all_mean(mse.detach(), group)

    if time_conditioned:

        def step(state, poses, times, targets, masks):
            return run(state, poses, np.asarray(times, np.float32), targets, masks)

    else:

        def step(state, poses, targets, masks):
            return run(state, poses, np.zeros(len(poses), np.float32), targets, masks)

    return init, step
