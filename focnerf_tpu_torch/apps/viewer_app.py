"""Interactive viewer CLI: serve a checkpoint (or a live training run) in the
browser.

Twin of focnerf_tpu/apps/viewer_app.py (the reference's NeRFGUI, --gui in
main_nerf.py, as a web server that works headless):

  - without --test, the viewer trains while you watch (NeRFGUI train mode,
    nerf/gui.py:89-111) on the scene's 'background' (or
    --objects_of_interest) object; without a trainable scene it falls back
    to view-only, as JAX's does;
  - --test views the workspace only: a hash checkpoint (through the
    occupancy march under --cuda_ray), a D-NeRF checkpoint with the time
    slider (the slot's bitfield of the time grid), the same hash checkpoint
    baked (--baked: the cache with its staleness rule, the bake gate), a
    voxel-trained volume (main_voxel's baked npz, uint8-resident under
    --bake_quantize) or a dynamic voxel / K-planes field collapsed at the
    slider's time (the newer cache wins when both exist).

Frames are rendered under ``torch.no_grad()`` (never ``inference_mode``: the
trainer's tensors go back into autograd) and handed to the server as numpy.
While training, one lock is held by every train step of the burst thread
and by every render and action: the port updates parameters and the EMA in
place, so a render must not read them mid-step. The lock is handed out in
the order it is asked for (``_FairLock``), so a waiting render goes before
the burst's next step.

Usage:
  python -m focnerf_tpu_torch.apps.viewer_app <scene> --workspace ws_background [--test]
  VIEWER_PORT=0 python -m focnerf_tpu_torch.apps.viewer_app <scene> --workspace ws --test -O
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from focnerf_tpu_torch import resolve_device
from focnerf_tpu_torch.config import parse_options


def _ctl(settings, occ_kwargs=None, aabb_ok=False, device=None):
    """Live control-panel values -> (bg_color, render kwargs, aabb).

    dt_gamma/max_steps apply only on occupancy-marched paths; aabb only
    where the staged renderer accepts one (ref gui.py:156-427 sliders).
    """
    kw = dict(occ_kwargs or {})
    bg = 1.0
    aabb = None
    if settings:
        bg = float(settings.get("bg", 1.0))
        if kw.get("occ_bits") is not None or "dt_gamma" in kw:
            if settings.get("dt_gamma") is not None:
                kw["dt_gamma"] = float(settings["dt_gamma"])
            if settings.get("max_steps"):
                kw["max_steps"] = int(settings["max_steps"])
        if aabb_ok and settings.get("aabb"):
            aabb = torch.tensor(settings["aabb"], dtype=torch.float32, device=device)
    return bg, kw, aabb


def _host(img) -> np.ndarray:
    return img.float().cpu().numpy()


def _shear_warp_fn(volume_at, density_scale: float = 1.0):
    """render_fn over a baked volume: ``volume_at(t)`` gives the volume of
    the slider's time. A camera inside the volume (shear-warp undefined)
    gets a flat frame instead of NaN garbage."""
    from focnerf_tpu_torch.render.baked import render_baked

    def render_fn(pose, intrinsics, H, W, t, settings=None):
        bg, _, _ = _ctl(settings)
        with torch.no_grad():
            try:
                img, _, _ = render_baked(volume_at(float(t)), pose, intrinsics, H, W, bg_color=bg,
                                         density_scale=density_scale)
            except ValueError:  # camera inside the volume
                return np.ones((H, W, 3), np.float32)
            return _host(img)

    return render_fn


def _view_only(opt, device=None):
    """Load a workspace for viewing; returns (render_fn, None)."""
    from focnerf_tpu_torch.models.dnerf import DNeRFConfig
    from focnerf_tpu_torch.render.renderer import render_image
    from focnerf_tpu_torch.train.checkpoints import load_object_occupancy, load_object_params

    device = resolve_device(device)
    ckpt_dir = os.path.join(opt.workspace, "checkpoints")
    dyn_cache = os.path.join(opt.workspace, f"dynvoxel_{opt.bake_res}_sh{opt.bake_sh}.npz")
    kp_cache = os.path.join(opt.workspace, f"kplanes_{opt.bake_res}_sh{opt.bake_sh}.npz")
    if opt.baked and not os.path.isdir(ckpt_dir) and (os.path.exists(dyn_cache) or os.path.exists(kp_cache)):
        # dynamic voxel workspace (main_voxel --voxel_dynamic / --voxel_kplanes):
        # collapse the factorized field at the slider's t, then shear-warp
        # render. When both families were trained here, the NEWEST field
        # wins: the latest training run, not a fixed priority
        newest_is_kp = os.path.exists(kp_cache) and (
            not os.path.exists(dyn_cache) or os.path.getmtime(kp_cache) >= os.path.getmtime(dyn_cache))
        if newest_is_kp:
            from focnerf_tpu_torch.train.voxel_kplanes import kplanes_field_to_volume as to_volume
            from focnerf_tpu_torch.train.voxel_kplanes import load_kplanes_field as load

            dyn_cache = kp_cache
        else:
            from focnerf_tpu_torch.train.voxel_dynamic import dyn_field_to_volume as to_volume
            from focnerf_tpu_torch.train.voxel_dynamic import load_dyn_field as load

        field, bound_l, sh_l = load(dyn_cache, device=device)
        print(f"[viewer] loaded dynamic voxel field {dyn_cache}")
        return _shear_warp_fn(lambda t: to_volume(field, t, bound_l, sh_l)), None

    baked_cache = os.path.join(opt.workspace, f"baked_{opt.bake_res}_sh{opt.bake_sh}.npz")
    if opt.baked and not os.path.isdir(ckpt_dir) and os.path.exists(baked_cache):
        # voxel-trained workspace (apps/main_voxel.py): there is no network
        # checkpoint, the volume IS the model; --bake_quantize serves it
        # uint8-RESIDENT (dequantized inside the fold)
        from focnerf_tpu_torch.render.baked import load_volume

        vol = load_volume(baked_cache, resident=opt.bake_quantize, device=device)
        print(f"[viewer] loaded voxel volume {baked_cache}" + (" (uint8-resident)" if opt.bake_quantize else ""))
        return _shear_warp_fn(lambda t: vol), None

    params, cfg = load_object_params(
        ckpt_dir, None if os.path.exists(os.path.join(ckpt_dir, "model_config.json")) else opt.nerf_config(),
        device=device)
    print(f"[viewer] loaded checkpoint from {ckpt_dir}")
    occ = load_object_occupancy(ckpt_dir, cfg, device=device) if opt.cuda_ray else None

    if isinstance(cfg, DNeRFConfig):
        from focnerf_tpu_torch.render.dnerf_renderer import (
            TimeOccupancyState,
            render_image_dnerf,
            time_occupancy_bitfield,
        )

        occ_kwargs, bits_at = {}, None
        if occ is not None:
            # per-t bitfield slice of the time-axis grid (dnerf/renderer.py:286)
            occ = TimeOccupancyState(*occ)
            bits_at = lambda t: time_occupancy_bitfield(occ, t, opt.density_thresh)  # noqa: E731
            occ_kwargs = dict(dt_gamma=opt.dt_gamma, max_steps=opt.max_steps, slab=max(opt.train_slab, 64))
            print("[viewer] occupancy-accelerated dnerf rendering on")

        def render_fn(pose, intrinsics, H, W, t, settings=None):
            bg, kw, _ = _ctl(settings, occ_kwargs)
            with torch.no_grad():
                if bits_at is not None:
                    kw["occ_bits"] = bits_at(float(t))
                img, _ = render_image_dnerf(
                    params, cfg, pose, intrinsics, H, W, float(t), num_steps=min(opt.num_steps, 128),
                    max_ray_batch=opt.max_ray_batch, min_near=opt.min_near, bg_color=bg, **kw,
                )
                return _host(img)

        return render_fn, None

    occ_kwargs = {}
    if occ is not None:
        from focnerf_tpu_torch.ops.occupancy import occupancy_bitfield

        occ_kwargs = dict(occ_bits=occupancy_bitfield(occ, opt.density_thresh), dt_gamma=opt.dt_gamma,
                          max_steps=opt.max_steps, slab=max(opt.train_slab, 64))
        print("[viewer] occupancy-accelerated rendering on")

    obj_feat = torch.zeros(cfg.yolo_feats_dim, device=device) if cfg.use_objfeat else None

    if opt.baked:
        # real-time path: bake once, every frame is a shear-warp render
        # (the answer to the GUI's 200 ms frame budget, nerf/gui.py:134-140)
        vol = _baked_volume(opt, params, cfg, ckpt_dir, obj_feat, occ_kwargs.get("occ_bits"), device)
        return _shear_warp_fn(lambda t: vol, cfg.density_scale), None

    def render_fn(pose, intrinsics, H, W, t, settings=None):
        bg, kw, aabb = _ctl(settings, occ_kwargs, aabb_ok=True, device=device)
        img, _ = render_image(
            params, cfg, pose, intrinsics, H, W, num_steps=min(opt.num_steps, 128),
            max_ray_batch=opt.max_ray_batch, min_near=opt.min_near, obj_feat=obj_feat, bg_color=bg,
            aabb=aabb, **kw,
        )
        return _host(img)

    return render_fn, None


def _baked_volume(opt, params, cfg, ckpt_dir, obj_feat, occ_bits, device):
    """The hash checkpoint's baked volume for ``--baked``: the workspace's
    cache when it is not older than the newest checkpoint, else a new bake
    (saved, and probed by the bake gate unless ``--no-bake_gate``). A
    quantized cache read with fp16 asked for is re-baked; an fp16 cache read
    with ``--bake_quantize`` is re-saved as uint8. Under ``--bake_quantize``
    the volume is served uint8-resident."""
    from focnerf_tpu_torch.render.baked import bake_field, load_volume, quantize_volume, save_volume

    from focnerf_tpu_torch.train.checkpoints import _CKPT_RE

    cache = os.path.join(opt.workspace, f"baked_{opt.bake_res}_sh{opt.bake_sh}.npz")
    # the newest step checkpoint (JAX's orbax step directories)
    latest = max((os.path.getmtime(os.path.join(ckpt_dir, d)) for d in os.listdir(ckpt_dir) if _CKPT_RE.match(d)),
                 default=0.0)
    if os.path.exists(cache) and os.path.getmtime(cache) >= latest:
        with np.load(cache) as z:
            cache_is_q = "q_payload" in z.files
        if cache_is_q and not opt.bake_quantize:
            # a uint8 cache re-encoded as fp16 would silently keep the
            # quantization loss while the format claims full precision
            print("[viewer] quantized cache + fp16 requested: re-baking")
        elif opt.bake_quantize and cache_is_q:
            print(f"[viewer] loaded baked volume cache {cache} (uint8-resident)")
            return load_volume(cache, resident=True, device=device)
        else:
            vol = load_volume(cache, device=device)
            print(f"[viewer] loaded baked volume cache {cache}")
            if opt.bake_quantize:
                # fp16 cache + uint8 requested: convert the full-precision
                # data in place, then serve it resident
                save_volume(cache, vol, quantize=True)
                print("[viewer] re-saved cache as uint8 (resident)")
                return quantize_volume(vol)
            return vol
    t0 = time.time()
    with torch.no_grad():
        vol = bake_field(params, cfg, resolution=opt.bake_res, obj_feat=obj_feat, occ_bits=occ_bits,
                         sh_degree=opt.bake_sh)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"[viewer] baked {opt.bake_res}^3 volume in {time.time() - t0:.1f}s")
    save_volume(cache, vol, quantize=opt.bake_quantize)
    if opt.bake_gate:
        from focnerf_tpu_torch.core.camera import rand_poses
        from focnerf_tpu_torch.render.bake_gate import bake_quality_report

        probe = rand_poses(np.random.default_rng(0), 3, radius=max(opt.radius, 1.5))
        f = 1.1 * 200
        with torch.no_grad():
            rep = bake_quality_report(
                params, cfg, vol, probe, (f, f, 100.0, 100.0), 200, 200, obj_feat=obj_feat, occ_bits=occ_bits,
                num_steps=min(opt.num_steps, 256), out_path=os.path.join(opt.workspace, "bake_quality.json"),
            )
        print(f"[bake-gate] baked-vs-exact {rep['psnr_baked_vs_exact_mean']} dB mean")
    return quantize_volume(vol) if opt.bake_quantize else vol


class _FairLock:
    """A lock handed out in the order it was asked for. ``threading.Lock`` is
    not: the burst thread releases it after a step and asks again at once,
    and where steps are fast it takes it back before a waiting render wakes,
    so the view froze for whole bursts."""

    def __init__(self):
        self._cond = threading.Condition()
        self._next = 0  # the next ticket to hand out
        self._serving = 0  # the ticket that holds the lock

    def __enter__(self):
        with self._cond:
            ticket = self._next
            self._next += 1
            self._cond.wait_for(lambda: self._serving == ticket)

    def __exit__(self, *exc):
        with self._cond:
            self._serving += 1
            self._cond.notify_all()


def _train_while_viewing(opt, device=None):
    """Build the dataset and a Trainer; returns (render_fn, train_fn, actions)."""
    from focnerf_tpu_torch.apps.main_nerf import detected_objects, mask_details_for
    from focnerf_tpu_torch.data.provider import NeRFDataset
    from focnerf_tpu_torch.data.yolo_sidecar import load_sidecar
    from focnerf_tpu_torch.render.renderer import render_image
    from focnerf_tpu_torch.train.trainer import Trainer

    device = resolve_device(device)
    sidecar = load_sidecar(opt.path, "train")
    obj = detected_objects(sidecar, opt)[0]
    train_ds = NeRFDataset(opt.dataset_options(), split="train", mask_details=mask_details_for(sidecar, obj),
                           detected_object=obj, device=device)
    trainer = Trainer(
        "ngp", opt.nerf_config(), workspace=f"{opt.workspace}_{obj}", lr=opt.lr, iters=opt.iters,
        num_steps=opt.num_steps, max_ray_batch=opt.max_ray_batch, use_occupancy=opt.cuda_ray,
        dt_gamma=opt.dt_gamma, max_steps=opt.max_steps, train_slab=opt.train_slab,
        density_thresh=opt.density_thresh, min_near=opt.min_near, use_checkpoint=opt.ckpt, seed=opt.seed,
        device=device,
    )
    print(f"[viewer] training object {obj!r} while viewing")
    if train_ds.obj_feats is not None:
        obj_feat = torch.as_tensor(train_ds.obj_feats.mean(0), device=device)
    else:
        obj_feat = torch.zeros(trainer.cfg.yolo_feats_dim, device=device) if trainer.cfg.use_objfeat else None
    lock = _FairLock()  # every train step, render and action: the state updates in place

    def render_fn(pose, intrinsics, H, W, t, settings=None):
        with lock, torch.no_grad():
            kw = trainer._render_kwargs()  # routes through occupancy when trained with it
            kw["num_steps"] = min(opt.num_steps, 128)  # interactive budget
            bg, kw, aabb = _ctl(settings, kw, aabb_ok=True, device=device)
            img, _ = render_image(trainer.state.ema_params, trainer.cfg, pose, intrinsics, H, W,
                                  obj_feat=obj_feat, bg_color=bg, aabb=aabb, **kw)
            return _host(img)

    def train_fn():
        with lock:
            return float(trainer.train_step_once(train_ds)["loss"])

    # control-panel buttons (ref gui.py save_mesh / checkpoint buttons)
    def _save_ckpt():
        with lock:
            trainer.save_checkpoint()
            return f"checkpoint saved @ step {int(trainer.state.step)}"

    def _save_mesh():
        with lock:
            trainer.save_mesh(resolution=128)
        return "mesh saved"

    actions = {"save_ckpt": _save_ckpt, "save_mesh": _save_mesh}
    return render_fn, train_fn, actions


def main(argv=None, device=None):
    """CLI entry; ``device`` None means ``cuda`` (raises without CUDA).
    Serves until interrupted on ``$VIEWER_PORT`` (default 7007; 0 picks a
    free port, which the first line names)."""
    from focnerf_tpu_torch.viewer.server import ViewerState, run_viewer

    opt = parse_options(argv)
    device = resolve_device(device)
    actions = None
    if opt.test:
        render_fn, train_fn = _view_only(opt, device)
    else:
        try:
            render_fn, train_fn, actions = _train_while_viewing(opt, device)
        except FileNotFoundError as e:
            print(f"[viewer] no trainable scene ({e}); falling back to view-only")
            render_fn, train_fn = _view_only(opt, device)

    state = ViewerState(render_fn, W=opt.W // 2, H=opt.H // 2, train_fn=train_fn, max_spp=opt.max_spp,
                        actions=actions)
    run_viewer(state, port=int(os.environ.get("VIEWER_PORT", 7007)))


if __name__ == "__main__":
    main()
