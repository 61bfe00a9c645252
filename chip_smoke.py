#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (focnerf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure ends the run with a
non-zero exit code and no result line:

  1. device: torch's name for card 0 and nvidia-smi's name and power limit;
  2. build: every CUDA kernel library of the port from csrc/ (nvcc, sm_90a,
     one process per source, all at once), with the seconds it took;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes of the path that runs it, with its time, the plain version's
     time, the library call's time where one PyTorch call computes the same
     function, and the least time the card could take (its bound): the
     composite forward and backward on the inputs their lane groups make
     risky (T 16, 32, 100, 128; inf spikes at chunk starts), the forward
     with no, a scalar and a per-ray background, with a carried optical
     depth (``composite_rays_resume``) and on the two-segment identity,
     timed at [4096, 128] (T_thresh 1e-4 and 0), [4096, 16] and, with a
     carried optical depth, at the iterative round's [65536, 16]; the
     forward at the uniform composition row [4096, 512], T_thresh 0 (16
     chunks a ray, thin rays carried through all of them), held and timed; the
     backward timed at [4096, 128] and [4096, 16]; the hash-table
     gradient scatter on the -O encode of 4096 x 128 and 4096 x 16 points,
     on one level-0 cell, on the exact 8-corner layout and at one and four
     channels, timed at the two -O shapes; then, at the training paths'
     newer shapes, held and timed: the composite forward and backward at
     [4096, 192] and [4096, 576] (T_thresh 0, the uniform path with
     importance samples), the table gradient on the exact layout of 4096 x
     192 points (with ``index_add_``'s time) and on half the levels of the
     -O encode (one phase of ``--grad_level_phases 2``);
  4. serving: a blender-layout scene with 800x800 test views, a checkpoint
     of the default full-width model (seeded weights; the density grid is
     the field's sigma at every cell centre) and
     ``main_nerf <scene> --test -O``; the renders must exist, and the
     composite kernel must have run once per 4096-ray chunk of every view
     and the encode kernel once per encode the model asked for;
  4b. encode kernels (``[kernel-encode]``): the hash encode forward and
     its position gradient (``csrc/hashgrid_fwd.cu``) against their plain
     versions on the card, rows bit for bit, weights and out within a few
     ulp, the position gradient within 1e-5 rel L2, with points on cell
     faces and outside the cube: the -O training encode (4096 x 128
     points, K 1 on 16 levels, residuals on), the exact serving encode at
     the most points one of phase 4's ladder chunks encoded, an -O2 c2f
     stage with grad_levels, the background grid (D = 2), and D-NeRF's
     deform (D = 3) and hyper (D = 5) fields with the position gradient;
     the kernels, the plain versions and their bounds timed at the -O,
     serving and deform shapes;
  5. training: an analytic RGBA sphere scene at 800x800 with train, val and
     test splits and its object-mask sidecar (the sphere's alpha),
     ``main_nerf <scene> -O --iters 400`` at full width with its default
     eval renderer (``iter``); each backward kernel must run once per step,
     the composite forward at least once per step and
     ``composite_rays_resume`` once per round of the eval, the loss must
     fall by half, the val PSNR must reach 20 dB and a checkpoint must
     exist; then ``--test -O`` serves from the trained checkpoint (a
     trained, sparse grid); the val views are evaluated with ``iter`` (1;
     the training's own eval renders all 4 with it), ``iter_dev`` (1) and
     ``oneshot`` (the centre 400x400 of 1) (s/view, rounds, launches,
     PSNR: the two iterative renders must agree within 1e-4 mean per view
     and neither may fall 0.5 dB below ``oneshot`` on its pixels); 3 more steps
     are profiled: stage times, the device's busy share and top kernels;
     nvidia-smi samples the SM clock beside each timed training window and
     the table-gradient timing; on one train step at each of the slabs 128,
     32 and 16, the composite backward must mask (T_in < T_thresh) exactly
     the samples the forward's loop masks; each training step must launch
     the skip-walk kernel once, and the eval once a round;
  5b. march kernel (``[kernel-march]``): ``march_rays_skip`` against its
     plain walk on the card, ts, dts, valid and count bit for bit, on
     phase 5's trained skip field: a training batch at the slabs 128, 32
     and 16 (jittered), the iterative eval round's starts (no jitter, and
     under a cap of iterations), and after phase 17 D-NeRF's time grid;
     timed at slab 128 (the kernels line) and 16 and at the round's start,
     beside the plain walk and the bound;
  6. reference: one small view rendered on the card (kernel) and on the CPU
     (plain versions) must agree, through the occupancy path and through the
     uniform path of ``main_nerf --test`` without ``-O`` (the serving
     model), and through the iterative renderer (the trained model); and
     train steps' losses and gradients on the card must agree with the
     CPU's: the -O step, the uniform step with importance upsampling, an
     -O2 step in a truncated c2f stage on a gradient phase (the other
     levels' rows exactly 0), the -O step on a patch-sampled batch and with
     the TV term;
  6a. fused (``[fused]``): ``--steps_per_dispatch`` on the card: the first
     chunk of ``-O`` (K 16) and ``-O2`` (K 4, two gradient phases) against
     per-step trainers of the same seed (losses 1e-4 relative, the hash
     table 1e-3 rel L2; one graph captured per phase, the rest replays; the
     backward kernels and the walk once a step), the steady state of each
     at full width, ``main_nerf -O --steps_per_dispatch 16`` beside the run
     per step (ms/step, occupancy updates' share, replays, launches; both
     losses must halve) and the dense 256^3 voxel engine at K 8 beside per
     step (the first chunk's mse 1e-4 relative);
  6b. uniform training: ``main_nerf`` without ``-O`` at full width on phase
     5's scene (one val view), UNIFORM_ITERS steps of 128 + 64 importance
     samples a ray with ``--error_map`` and ``--tv_weight``: ms/step,
     samples/step, peak memory; the loss must halve, the val PSNR be
     finite, the error map move on exactly the views the batches drew,
     each backward kernel launch once a step and the forward once a step
     plus once per eval chunk, and the exported mesh have faces;
  7. composition: a second object (BALL, a smaller sphere of other colours
     beside the first, constant non-zero object features) is trained with
     ``main_nerf -O2 --c2f 50:8,100:12`` on a scene with the same cameras
     (ms/step per c2f stage; the table gradient once a step, on the columns
     of that step's level subset; its eval of one val view launches
     ``composite_rays_resume``); both objects are laid
     out as ``<root>/ws_<obj>/checkpoints`` with ``<root>/obj_feats/``, and
     ``combined`` composes the val views of both spheres together (occupancy
     path, K=2 resident): s/view, peak memory, PSNR_w >= 20 dB, the forward
     kernel launched once per 4096-ray chunk of every view and the plain
     compositor given no CUDA tensor; then ``editable --edit_object ball
     --offset_x 0.3`` the same way, with its video (or PNG frames);
  8. composition reference: a 64x64 view composed on the card and on the
     CPU from the same checkpoints (plain, translated edit, rotate_z 90 on
     the uniform path at 512 steps) must agree as the render checks do;
     composing [A, A] must equal [A] bit for bit, and [A] composed must
     equal ``render_image`` of A within 1e-5; then one composed 800x800
     view is profiled by stage, and the same camera at 200x200 under
     torch.profiler;
  9. baked reference: the shear-warp renderer on the card against the CPU
     on an analytic two-blob volume at 64^3, 96x96 views from six poses
     (every axis and flip), dense sh_deg 0 and 2 and uint8-resident: the
     core in fp32 under the render gates, ``render_baked`` (bf16
     resampling) within BAKED_BF16_PSNR dB; shift, rotation by 90 degrees
     and merge to the bit, rotation by 30 degrees within 1e-5;
 10. baked composition: ``combined --baked`` (each object baked at 256^3,
     its gate report written, merged) and ``editable --baked --bake_quantize
     --edit_object ball --offset_x 0.3 --rotate_z 90`` over the same val
     views, through phase 7's runner (launch counts, plain-compositor
     guard): ``[baked]`` lines with the bake, gate, merge and quantization
     seconds, ms per frame, peak memory, each object's gate PSNR and PSNR_w
     beside phase 7's; PSNR_w >= 20 dB and the forward kernel launched (the
     gate's exact probes);
 11. baked profile: one 800x800 frame at 256^3 (dense, uint8-resident, and
     dense sh_deg 2) by stage, and the device's busy share;
 12. procedural: ``make_hard_scene`` at gt_res 256 and 800x800 on the card;
     ms per GT frame; a val PNG within 1/255 of its frame;
 13. voxel reference: a dense and a K-planes train step at 32^3 on 64x64
     views, on the card against the CPU: loss and every gradient in fp32
     (loss <= 1e-4 relative, gradients <= 1e-3 relative L2), and the card's
     default bf16 step's loss within 1e-2;
 14. voxel: ``main_voxel`` through its entry point, dense 256^3 on phase 5's
     sphere scene (300 steps on the c2f ladder 64, 128, 256, ri 512, remat
     on, ``--steps_per_dispatch 8``: each stage's steps from CUDA graphs) and VM rank 16 at 128^3 with ``--bake_quantize`` (150 steps) (each: the train
     loss must halve and the val PSNR reach 20 dB; the baked npz and the
     mesh must exist), 20 steps at 256^3 with remat on and off (ms/step,
     peak memory), then ``--voxel_dynamic`` and ``--voxel_kplanes 8`` at
     128^3 on the dynamic hard scene (400x400, GT at 128^3, 50 steps; a
     finite val PSNR): ms/step, supervised rays/s, peak memory, kernel
     launches (none: the voxel path runs neither kernel);
 15. voxel profile: one dense 256^3 train step by stage (relayout, hat
     matrices, resample, fold; forward, backward with its recompute, Adam)
     and 5 steps under torch.profiler for the device's busy share;
 16. D-NeRF kernel (``[kernel-dnerf]``, run right after phase 3's
     kernels): the table gradient on the hyper field's 5-D layout (4096 x
     128 points, 16 levels x 32 corners, J = 512) against its plain
     version, timed beside ``index_add_``;
 17. D-NeRF (``[dnerf]``): a moving RGBA sphere at 400x400 (50 train
     frames, each with its time; 4 val, 4 test), ``main_dnerf -O
     --dnerf_variant deform --iters 700 --time_slots 8 --lr_net 1e-3`` at
     full width: warm median ms/step, peak memory, the loss curve's ends, val PSNR (gate 18
     dB), each backward kernel once a step and the forward at least once,
     the time grid refreshed (more than one slot non-zero), the meshes at
     t = 0 and t = 1 and the checkpoint; then ``--test -O`` renders the
     test split across time and its video, and 3 more steps are profiled
     (``[dnerf-profile]``: busy share, top kernels);
 18. D-NeRF reference (``[dnerf-reference]``): a train step of deform (the
     trained params; on the slot's skip walk and on uniform samples), basis
     and hyper on the card against the CPU in fp32 (loss and every
     gradient, the deformation and hyper nets' through the encode's position
     gradient) over the rays on which both took the same piece of every
     piecewise function (encode cell, ReLU, early exit, march count; at
     most 10% of the rays left out), and a 64x64 view at t = 0.5 through
     the slot's bitfield;
 19. D-NeRF variants (``[dnerf-variants]``): basis and hyper under ``-O``
     and deform without it (512 uniform samples) for 20 full-width steps:
     ms/step, peak memory, a finite falling loss, one backward launch each a
     step.

 20. viewer (``[viewer]``): ``python -m focnerf_tpu_torch.apps.viewer_app
     <phase 5 scene> --workspace <phase 5 workspace> --test -O`` in a process
     of its own on a free port (``VIEWER_PORT``): /status within 60 s, the
     page, /render until spp goes 1 -> 2 on one camera, /control bg 0
     resetting it, every PNG decoded by data/png.py (the card's machine has
     no PIL) at the size the downscale gives, then terminated; in process,
     one 400x400 frame through ``_view_only`` of each workspace kind (phase
     5's checkpoint, 40 composite launches a frame; the same ``--baked
     --bake_res 128``, then from its cache; phase 14's dense volume and
     K-planes field at t = 0 and 0.5, which must differ; phase 17's D-NeRF
     checkpoint at t = 0 and 1 from a test camera, each nearer its own
     time's analytic spheres) with its s/frame and PSNR against the
     analytic spheres (floor 15 dB for the static kinds);
     train-while-viewing on phase 5's scene in a fresh workspace: two
     16-step bursts behind a server with renders between them (at least
     one between two steps of one burst), finite losses, each backward kernel once a step, save_ckpt through /action, no
     step after the pause, the threads joined;
 21. LPIPS (``[lpips]``): with a random-weight npz in FOCNERF_LPIPS_NPZ, a
     Trainer on phase 5's checkpoint evaluates the val views and reports
     ``LPIPS (alex, torch)``; ``lpips_distance`` on the card equals the
     CPU's within 1e-4 relative on one 800x800 view pair;
 22. no-preload (``[no-preload]``): the native loader built from
     native/dataloader.cpp into focnerf_tpu_torch/build/ (its path
     printed), ``main_nerf <phase 5 scene> --no-preload --cuda_ray --iters
     100`` at full width: ms/step, peak memory, launches (each backward once
     a step), the loss of the last 10 steps under the first 10's; the first
     3 host batches' pixels within 1/255 of the preloaded images at the
     pixels their rays leave through; then the trained model steps on host
     and on preloaded batches in turns for ms/step.

 23. CLIP (``[clip]``): a ``main_nerf -O --n_chunks 0 --rand_pose 3``
     trainer on phase 5's scene with a seeded stand-in CLIP loss (the
     repository holds no CLIP weights; ``StandInCLIP``) trains 20 steps at
     full width, every fourth a GT-free CLIP step on a 66x66 random-pose
     image (4356 rays x 128 samples): finite losses, the CLIP steps where
     the schedule puts them, each backward kernel once a step, peak memory;
     one CLIP step on the card against the CPU in fp32 (loss 1e-4 relative,
     every gradient 1e-2 rel L2 and nonzero); ms per CLIP step; the
     composite forward and backward at [4356, 128] and the table gradient
     at 557,568 points held against their plain versions (1e-5) and timed;
     then ``main_nerf --rand_pose 0 --clip_text "a sphere"`` on four of
     phase 5's views without a sidecar or ``--disable_yolo``: this machine
     has neither ultralytics nor transformers, so it writes the
     background-only sidecar, says once that no CLIP loss is available and
     trains its 4 steps.
 24. parallel (``[parallel]``, ``parallel/``): the -O data-parallel
     occupancy step at full width on world size 1 over NCCL in this process,
     with the VM (512^3, rank 8) and K-planes (256^3, rank 8, 16 slots)
     one-device steps (``make_*_dp_step`` at world 1), then 2 ranks on the
     one card over gloo, each a subprocess with its own timeout
     (``parallel_rank``): 10 DP steps of phase 5's 4096-ray global batches
     (the first step's loss within 1e-4 and table update within 1e-2 rel L2
     of the world-1 step, every rank's params bit for bit equal after the
     10, each kernel launched), ``compose_rays_sharded`` at K = 2 against
     ``compose_rays`` (mean 1e-4), one slice-parallel dense step at 256^3
     against one device (loss and field update 1e-2), the collapse-sharded
     VM step at 512^3 and K-planes step at 256^3 against their one-device
     steps (mse and factor update 1e-2, both ranks' factors bit for bit
     equal after 1 and 3 steps; ms per step and each rank's peak memory),
     ``main_voxel --voxel_sp --voxel_dp 2`` in the ranks' group; then
     ``torchrun --nproc_per_node 2 -m focnerf_tpu_torch.apps.main_voxel
     --voxel_sp`` at 256^3 for 24 steps (rank 0 alone writes and prints
     ``[spvoxel]``), and ``torchrun ... --voxel_sp --voxel_kplanes 8
     --voxel_c2f 2`` at 256^3 for 24 steps on phase 14's dynamic hard scene
     (one writer prints ``[kplanes] SP over 2 devices``; the npz loads; the
     logged mse finite and falling; a finite val PSNR). The dense voxel
     runs load phase 5's first 8 train views and first val view.

Every phase prints ``[phase-start] <name>`` before it starts (so a failure
names its phase) and its seconds after (``[phase] <name>: s``).

The last line is {"ok": true, "device": {...}}; the line before it lists
every kernel with its launches on the training path (``launches``), in the
``combined`` run (``launches_compose``), in the ``editable`` run
(``launches_edit``), in the two ``--baked`` runs
(``launches_baked_compose``, ``launches_baked_edit``), over phase 14's
voxel runs (``launches_voxel``), in the uniform training run
(``launches_uniform``), in the second object's ``-O2`` run
(``launches_o2``), in phase 17's D-NeRF training run (``launches_dnerf``), in
phase 20's train-while-viewing run (``launches_viewer``), in phase 22's
``--no-preload`` run (``launches_no_preload``) and in phase 23's 20 steps
with CLIP steps (``launches_clip``), summed over [parallel]'s two gloo
ranks, in their 10 DP steps and sharded composition (``launches_parallel``),
and in [fused]'s ``main_nerf -O --steps_per_dispatch 16`` run
(``launches_fused``, graph replays counted).
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# test views served (cut from 4 to pay for [clip]), side, rays per chunk
VIEWS, RES, CHUNK = 2, 800, 4096
# 400 steps, from 500, for the 900 s target on slower hosts: the loss is
# flat from step 250 (0.0030-0.0043 an epoch, val 26.62-26.64 dB at 500).
# Fewer do not keep the gates' margins: at 350 steps phase 5 read 23.86 dB
# and the composition's PSNR_w 20.66 (gate 20), at 300 22.93 dB
TRAIN_ITERS, TRAIN_VIEWS, VAL_VIEWS = 400, 50, 4
CAMERA_RADIUS, SPHERE_RADIUS = 3.0, 0.8  # ngp units; the bound box is [-2, 2]^3
# the composition's val cameras: every eye outside the bound box, as the
# shear-warp renderer needs (each coordinate-max >= 3.5 sin 60 / sqrt 2 > 2)
COMPOSE_RADIUS = 3.5
OBJECT = "sphere"  # the training scene's one object
# (centre, radius, colour where y < 0, colour where y >= 0) in ngp units
SPHERE = ((0.0, 0.0, 0.0), SPHERE_RADIUS, (0.9, 0.2, 0.1), (0.1, 0.3, 0.9))
BALL = ((0.0, 0.0, 1.35), 0.45, (0.95, 0.8, 0.1), (0.2, 0.8, 0.2))  # the composition's second object
# 150 steps, from 200, for the 900 s target on slower hosts (every c2f stage
# still runs: 50 steps at 16 levels)
SECOND, SECOND_ITERS = "ball", 150
# the second object's -O2 stages: (end step, active levels), at epoch ends
SECOND_C2F = ((50, 8), (100, 12))
# the uniform-sampling run (no -O): steps, (samples, importance samples), TV weight
# steps cut from 300 for the time limit (at 100 the mesh had no faces: the
# field's density stayed under the threshold 10)
UNIFORM_ITERS, UNIFORM_STEPS, UNIFORM_TV = 150, (128, 64), 1e-4
# views each eval renderer renders in phase 5 (the rest: VAL_VIEWS); cut
# from 4 (iter_dev: then from 2; iter: as the training's own eval renders
# all 4 with it) to keep the smoke within its time limit
EVAL_VIEWS = {"iter": 1, "iter_dev": 1, "oneshot": 1}
# oneshot renders the centre ONESHOT_CROP^2 of its view (the whole 800x800
# took ~29 s; cut to pay for [parallel]); the iterative renders are held
# to it on the same pixels
ONESHOT_CROP = 400
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
# the card's bf16 shear-warp against the CPU's fp32 render of the same volume
BAKED_BF16_PSNR = 35.0
GT_RES = 256  # the procedural scene's volume


def counters():
    """Every kernel wrapper, by the name the kernels line uses."""
    from focnerf_tpu_torch.ops import kernel_wrappers

    return {f.__name__: f for f in kernel_wrappers()}


def reset_counts():
    for f in counters().values():
        f.launches = 0


def read_counts() -> dict:
    return {name: f.launches for name, f in counters().items()}


class SMClocks:
    """Samples the card's SM clock (MHz) every 100 ms while the block runs,
    through nvidia-smi, and stops it on exit; ``summary()`` describes them."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits",
             "-lms", "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        )
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        rows = [line.split(",") for line in out.splitlines()]
        self.mhz = sorted(int(r[0]) for r in rows if len(r) == 2 and r[0].strip().isdigit())
        self.max_mhz = next((int(r[1]) for r in rows if len(r) == 2 and r[1].strip().isdigit()), None)

    def summary(self) -> str:
        if not self.mhz:
            return "SM clock not sampled"
        return (f"SM clock over {len(self.mhz)} samples: min {self.mhz[0]}, median "
                f"{self.mhz[len(self.mhz) // 2]}, max {self.mhz[-1]} MHz (card max {self.max_mhz})")


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[device] torch: {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()})")
    print(f"[device] nvidia-smi: {smi}")
    return smi


def phase_build():
    from focnerf_tpu_torch.ops import _build

    t0 = time.time()
    _build.build_all()
    for name in _build.KERNEL_SOURCES:
        _build.load_library(name)
    print(f"[build] {len(_build.KERNEL_SOURCES)} kernel libraries in {time.time() - t0:.1f} s "
          f"({', '.join(_build.KERNEL_SOURCES)}, one nvcc each, in parallel)")


def composite_inputs(t: int = 128, thin: bool = False, n: int = CHUNK):
    """An [n, t] chunk on the card: sigma U[0, 50] with inf spikes
    (trunc_exp's fp32 overflow), rgb, dt, t and a per-ray background.
    ``thin``: every fourth ray's sigma is scaled by 1e-3, so those rays keep
    their transmittance to the end of the row, and more inf spikes sit on
    such rays at samples 16, 32 and 64 (where the kernels' lane groups start
    a chunk)."""
    import torch

    g = torch.Generator().manual_seed(0)
    sig = torch.rand(n, t, generator=g) * 50.0
    if thin:
        sig[::4] *= 1e-3
        for k, ray in ((16, 400), (32, 404), (64, 408)):
            if k < t:
                sig[ray, k] = float("inf")
    sig[11, min(5, t - 1)] = float("inf")
    sig[200, 0] = float("inf")
    rgb = torch.rand(n, t, 3, generator=g)
    dts = torch.rand(n, t, generator=g) * 0.05 + 0.003
    ts = 2.0 + torch.cumsum(dts, -1)
    bg_rays = torch.rand(n, 3, generator=g)
    return tuple(x.cuda() for x in (sig, rgb, dts, ts, bg_rays))


def samples_read(sig, dts, thresh: float, od0=None) -> int:
    """Samples whose entering transmittance is >= thresh: what the kernels
    need to read (``od0``: the optical depth each ray carries in)."""
    import torch

    s = dts * sig
    acc = torch.cat([torch.zeros_like(s[:, :1]), torch.cumsum(s[:, :-1], -1)], -1)
    if od0 is not None:
        acc = acc + od0[:, None]
    return int((torch.exp(-acc) >= thresh).sum())


def od_error(got, want, thresh: float) -> float:
    """How far the kernel's outgoing optical depth is from the plain
    version's, relative to it: a ray must leave the worklist (exp(-od) <
    thresh) in both or in neither, and where it stays the two must agree.
    Where the kernel stopped early its od is the carry at the stop, below
    the row's sum, so only the decision is compared there."""
    import torch

    stays = torch.exp(-want) >= thresh
    if not torch.equal(stays, torch.exp(-got) >= thresh):
        return math.inf
    both = stays & torch.isfinite(want)
    if not torch.equal(torch.isinf(got[stays]), torch.isinf(want[stays])):
        return math.inf
    return float(((got - want).abs() / want.abs().clamp(min=1.0))[both].max())


def phase_composite_kernel() -> list:
    """The forward kernel vs its plain versions: composite_rays_fused vs
    composite_rays at T 16, 32, 100 (a ragged last chunk) and 128, thin
    rays and inf spikes at chunk starts, T_thresh 0 and 1e-4, no, a scalar
    and a per-ray background; composite_rays_resume vs
    composite_resume_plain with a nonzero carried optical depth; the
    two-segment identity (compositing [a|b] at once equals a, then b at the
    optical depth a left with). Then timed: composite_rays_fused at the
    serving chunk [4096, 128] with T_thresh 1e-4 and 0 and at [4096, 16]
    (the -O slab's small end), composite_rays_resume at the iterative
    round's [65536, 16] with a carried optical depth."""
    import torch

    from focnerf_tpu_torch.ops.composite import (
        composite_rays,
        composite_rays_fused,
        composite_rays_resume,
        composite_resume_plain,
        group_width,
    )
    from focnerf_tpu_torch.utils.measure import device_ms

    def finite(outs, what):
        if not all(torch.isfinite(a).all() for a in outs):
            raise AssertionError(f"composite forward kernel: non-finite output ({what})")

    errs, od_errs = {}, {}
    for t in (16, 32, 100, 128):
        sig, rgb, dts, ts, bg_rays = composite_inputs(t, thin=True)
        od0 = torch.rand(sig.shape[0], generator=torch.Generator(device="cuda").manual_seed(t),
                         device="cuda") * 8.0
        for thresh in (0.0, 1e-4):
            for bg_name, bg in (("none", None), ("scalar", 1.0), ("per-ray", bg_rays)):
                got = composite_rays_fused(sig, rgb, dts, ts, bg_color=bg, T_thresh=thresh)
                ref = composite_rays(sig, rgb, dts, ts, bg_color=bg, T_thresh=thresh)
                torch.cuda.synchronize()
                finite(got, f"T={t}, T_thresh={thresh}, bg {bg_name}")
                errs[("fused", t, thresh, bg_name)] = max(
                    float((a - b).abs().max()) for a, b in zip(got, (ref["image"], ref["weights_sum"], ref["depth"])))
            got = composite_rays_resume(sig, rgb, dts, ts, od0, T_thresh=thresh)
            ref = composite_resume_plain(sig, rgb, dts, ts, od0, T_thresh=thresh)
            torch.cuda.synchronize()
            finite(got[:3], f"resume T={t}, T_thresh={thresh}")
            errs[("resume", t, thresh)] = max(float((a - b).abs().max()) for a, b in zip(got[:3], ref[:3]))
            od_errs[("resume", t, thresh)] = od_error(got[3], ref[3], thresh)
            # two segments: [a|b] at once equals a, then b at a's outgoing od
            k = (3 * t) // 8 + 1  # not on a chunk boundary
            zero = torch.zeros_like(od0)
            whole = composite_rays_resume(sig, rgb, dts, ts, zero, T_thresh=thresh)
            a = composite_rays_resume(sig[:, :k].contiguous(), rgb[:, :k].contiguous(), dts[:, :k].contiguous(),
                                      ts[:, :k].contiguous(), zero, T_thresh=thresh)
            b = composite_rays_resume(sig[:, k:].contiguous(), rgb[:, k:].contiguous(), dts[:, k:].contiguous(),
                                      ts[:, k:].contiguous(), a[3], T_thresh=thresh)
            torch.cuda.synchronize()
            errs[("two segments", t, thresh)] = max(
                float((x + y - w).abs().max()) for w, x, y in zip(whole[:3], a[:3], b[:3]))
            od_errs[("two segments", t, thresh)] = od_error(b[3], whole[3], thresh)
    err, od_err = max(errs.values()), max(od_errs.values())
    # limit 1e-5: the kernel sums each ray's fp32 terms per lane and then as
    # a tree, the plain version through cumsum/sum reductions in another
    # order; od (a sum of up to 128 optical depths) relative 1e-5
    print(f"[kernel] composite forward max_abs_err {err:.3g} (limit 1e-5) over {len(errs)} cases: "
          f"composite_rays_fused T 16/32/100/128 x T_thresh 0/1e-4 x no/scalar/per-ray bg, "
          f"composite_rays_resume with od0 U[0, 8] and the two-segment identity at each T and T_thresh; "
          f"a quarter of the rays thin, inf spikes at samples 0, 5, 16, 32, 64; worst {max(errs, key=errs.get)}; "
          f"outgoing od relative error {od_err:.3g} (limit 1e-5, the leave/stay decision identical)")
    if not (err <= 1e-5 and od_err <= 1e-5):
        raise AssertionError(f"composite forward kernel disagrees with its plain version: {errs} {od_errs}")

    def bound(n, read, with_od):
        # bytes: (sigma, dt, ts, rgb) = 24 B of every sample whose entering
        # transmittance is >= T_thresh (the rest need not be read), the 12 B
        # background once, 20 B written per ray (resume: od0 read and od
        # written, no background: 28 B); ~17 fp32 operations (two exp) per
        # sample read
        nbytes = read * 24 + (n * 28 if with_od else 12 + n * 20)
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, read * 17 / FP32_OPS_PER_S * 1e3
        return max(bytes_ms, ops_ms), bytes_ms >= ops_ms, nbytes

    rows = {}
    for label, t, n, thresh in (("[4096,128] T_thresh=1e-4", 128, CHUNK, 1e-4),
                                ("[4096,128] T_thresh=0", 128, CHUNK, 0.0),
                                ("[4096,16] T_thresh=1e-4", 16, CHUNK, 1e-4)):
        sig, rgb, dts, ts, _ = composite_inputs(t, n=n)
        ms, span = device_ms(lambda: composite_rays_fused(sig, rgb, dts, ts, bg_color=1.0, T_thresh=thresh))
        plain_ms, plain_span = device_ms(lambda: composite_rays(sig, rgb, dts, ts, bg_color=1.0, T_thresh=thresh))
        read = samples_read(sig, dts, thresh)
        rows[label] = (ms, plain_ms, *bound(n, read, False))
        print(f"[kernel] composite_rays_fused {label}, {group_width(t)} lanes per ray: device {ms:.5f} ms "
              f"(call span {span:.4f} ms), plain device {plain_ms:.5f} ms (span {plain_span:.4f} ms), bound "
              f"{rows[label][2]:.5f} ms ({read} of {n * t} samples read, {rows[label][4]} B)")
    # the uniform composition row (compose_rays, rotation edits): [4096, 512]
    # at T_thresh 0, depth over the normalized t in [0, 1], 16 chunks of 32
    # samples a ray; a quarter of the rays thin, so their prefix is carried
    # through every chunk
    sig, rgb, dts, ts, bg_rays = composite_inputs(512, thin=True)
    ts = ts / ts[:, -1:]
    uni_errs = {}
    for bg_name, bg in (("none", None), ("scalar 0", 0.0), ("per-ray", bg_rays)):
        got = composite_rays_fused(sig, rgb, dts, ts, bg_color=bg, T_thresh=0.0)
        ref = composite_rays(sig, rgb, dts, ts, bg_color=bg, T_thresh=0.0)
        torch.cuda.synchronize()
        finite(got, f"T=512, bg {bg_name}")
        uni_errs[bg_name] = max(float((a - b).abs().max()) for a, b in zip(got, (ref["image"], ref["weights_sum"], ref["depth"])))
    uni_err = max(uni_errs.values())
    ms, span = device_ms(lambda: composite_rays_fused(sig, rgb, dts, ts, bg_color=0.0, T_thresh=0.0))
    plain_ms, plain_span = device_ms(lambda: composite_rays(sig, rgb, dts, ts, bg_color=0.0, T_thresh=0.0))
    read = samples_read(sig, dts, 0.0)
    rows["[4096,512] T_thresh=0"] = (ms, plain_ms, *bound(CHUNK, read, False))
    print(f"[kernel] composite_rays_fused [4096,512] T_thresh=0 (the uniform composition row), "
          f"{group_width(512)} lanes per ray, {512 // group_width(512)} chunks a ray: max_abs_err {uni_err:.3g} "
          f"(limit 1e-5) over no/scalar/per-ray bg, a quarter of the rays thin (their median T_out "
          f"{float(torch.exp(-(sig[::4] * dts[::4]).sum(-1)).median()):.3f}); device {ms:.5f} ms (call span "
          f"{span:.4f} ms), plain device {plain_ms:.5f} ms (span {plain_span:.4f} ms), bound "
          f"{rows['[4096,512] T_thresh=0'][2]:.5f} ms ({read} of {CHUNK * 512} samples read, "
          f"{rows['[4096,512] T_thresh=0'][4]} B)")
    if not uni_err <= 1e-5:
        raise AssertionError(f"composite forward kernel disagrees with its plain version at T=512: {uni_errs}")

    n, t, thresh = 65536, 16, 1e-4
    sig, rgb, dts, ts, _ = composite_inputs(t, n=n)
    od0 = torch.rand(n, generator=torch.Generator(device="cuda").manual_seed(5), device="cuda") * 8.0
    ms, span = device_ms(lambda: composite_rays_resume(sig, rgb, dts, ts, od0, T_thresh=thresh))
    plain_ms, plain_span = device_ms(lambda: composite_resume_plain(sig, rgb, dts, ts, od0, T_thresh=thresh))
    read = samples_read(sig, dts, thresh, od0)
    resume = (ms, plain_ms, *bound(n, read, True))
    print(f"[kernel] composite_rays_resume [{n},{t}] od0 U[0, 8], T_thresh=1e-4, {group_width(t)} lanes per ray: "
          f"device {ms:.5f} ms (call span {span:.4f} ms), plain device {plain_ms:.5f} ms (span "
          f"{plain_span:.4f} ms), bound {resume[2]:.5f} ms ({read} of {n * t} samples read, {resume[4]} B)")

    def entry(name, row):
        ms, plain_ms, bound_ms, by_bytes, _ = row
        return {
            "name": name,
            "route": "cuda",
            "source": "focnerf_tpu_torch/csrc/composite.cu",
            "replaces": "focnerf_tpu/ops/composite_pallas.py:95",
            "max_abs_err": max(err, uni_err),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if by_bytes else "operations",
            "library_ms": None,  # no single PyTorch call computes this function
        }

    return [entry("composite_rays_fused", rows["[4096,128] T_thresh=1e-4"]),
            entry("composite_rays_resume", resume)]


def phase_composite_backward_kernel() -> dict:
    """The backward kernel vs autograd of composite_rays: at T 16, 32, 100
    (a ragged last chunk) and 128, T_thresh 0 and 1e-4, scalar and per-ray
    backgrounds, inf spikes at chunk starts; then timed at [4096, 128] and
    [4096, 16] (the training slabs' ends), T_thresh 1e-4 (training's), a
    per-pixel background."""
    import torch

    from focnerf_tpu_torch.ops.composite import (
        composite_rays,
        composite_rays_fused,
        composite_rays_fused_backward,
        group_width,
    )
    from focnerf_tpu_torch.utils.measure import device_ms

    def case(t, thin, thresh, scalar_bg):
        sig, rgb, dts, ts, bg = composite_inputs(t, thin)
        bg = 1.0 if scalar_bg else bg
        n = sig.shape[0]
        g = torch.Generator(device="cuda").manual_seed(1)
        cot = tuple(torch.randn(s, generator=g, device="cuda") for s in ((n, 3), (n,), (n,)))
        with torch.no_grad():
            outs = composite_rays_fused(sig, rgb, dts, ts, bg_color=bg, T_thresh=thresh)

        def kernel():
            return composite_rays_fused_backward(sig, rgb, dts, ts, bg, outs, cot, T_thresh=thresh)

        def plain():
            s, c = sig.detach().requires_grad_(), rgb.detach().requires_grad_()
            out = composite_rays(s, c, dts, ts, bg_color=bg, T_thresh=thresh)
            return torch.autograd.grad((out["image"], out["weights_sum"], out["depth"]), (s, c), cot)

        return sig, dts, kernel, plain

    errs = {}
    for t in (16, 32, 100, 128):
        for thresh in (0.0, 1e-4):
            for scalar_bg in (True, False):
                _, _, kernel, plain = case(t, True, thresh, scalar_bg)
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                if not all(torch.isfinite(a).all() for a in got):
                    raise AssertionError(f"composite backward kernel: non-finite gradient at T={t}, "
                                         f"T_thresh={thresh}, scalar bg {scalar_bg}")
                errs[(t, thresh, scalar_bg)] = max(float((a - b).abs().max()) for a, b in zip(got, want))
    err = max(errs.values())
    # limit 1e-5: fp32 sums in another order (the kernel's prefix of w*gw is
    # a shuffle-tree scan, its suffix sums a total less a prefix)
    print(f"[kernel] composite_rays_fused_backward max_abs_err {err:.3g} vs autograd of the plain version "
          f"(limit 1e-5) over {len(errs)} cases: T 16/32/100/128 x T_thresh 0/1e-4 x scalar/per-ray bg, "
          f"a quarter of the rays thin, inf spikes at samples 0, 5, 16, 32, 64; worst "
          f"{max(errs, key=errs.get)}")
    if not err <= 1e-5:
        raise AssertionError(f"composite backward kernel disagrees with its plain version: {errs}")

    thresh, rows = 1e-4, {}
    for t in (128, 16):
        sig, dts, kernel, plain = case(t, False, thresh, False)
        n = sig.shape[0]
        ms, span = device_ms(kernel)
        plain_ms, plain_span = device_ms(plain)
        # bound: read 24 B of every sample read (as the forward), per ray the
        # background, the saved outputs and their cotangents (52 B); write
        # dsigma and drgb for every sample (16 B, zeros past the early exit);
        # ~35 fp32 operations (two exp) per sample read
        read = samples_read(sig, dts, thresh)
        nbytes = read * 24 + n * 52 + n * t * 16
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = read * 35 / FP32_OPS_PER_S * 1e3
        rows[t] = (ms, plain_ms, max(bytes_ms, ops_ms), bytes_ms >= ops_ms)
        print(f"[kernel] composite_rays_fused_backward [{n},{t}] T_thresh=1e-4, {group_width(t)} lanes per ray: "
              f"device {ms:.5f} ms (call span {span:.4f} ms), plain (forward + autograd backward) device "
              f"{plain_ms:.5f} ms (span {plain_span:.4f} ms), bound {rows[t][2]:.5f} ms ({read} samples "
              f"read, {nbytes} B)")
    ms, plain_ms, bound_ms, by_bytes = rows[128]
    return {
        "name": "composite_rays_fused_backward",
        "route": "cuda",
        "source": "focnerf_tpu_torch/csrc/composite.cu",
        "replaces": "focnerf_tpu/ops/composite_pallas.py:110",
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if by_bytes else "operations",
        "library_ms": None,  # no single PyTorch call computes this function
    }


def ray_points01(cfg, samples: int, g, n: int = CHUNK):
    """[n * samples, 3] points in [0, 1]^3: ``samples`` evenly spaced along
    each of n rays from one camera through the bound box."""
    import numpy as np
    import torch

    from focnerf_tpu_torch.core.camera import rand_poses
    from focnerf_tpu_torch.core.geometry import near_far_from_aabb
    from focnerf_tpu_torch.render.renderer import default_aabb

    dev = torch.device("cuda")
    pose = torch.from_numpy(rand_poses(np.random.default_rng(5), 1, radius=4.0)[0]).to(dev)
    d = torch.randn(n, 3, generator=g, device=dev) * 0.2 + pose[:3, 2]
    d = d / d.norm(dim=-1, keepdim=True)
    o = pose[:3, 3].expand(d.shape)
    near, far = near_far_from_aabb(o, d, default_aabb(cfg, dev), 0.2)
    frac = (torch.arange(samples, device=dev) + 0.5) / samples
    x = o[:, None] + d[:, None] * (near[:, None] + (far - near)[:, None] * frac)[..., None]
    return ((x + cfg.bound) / (2 * cfg.bound)).reshape(-1, 3)


def table_grad_inputs(cfg, samples: int = 128, stochastic: bool = True, one_cell: bool = False, n: int = CHUNK):
    """Rows and weights of the encode of n rays x ``samples`` points through
    the bound box (stochastic K=1 corners: the -O training encode; else 8
    exact corners per level), and a cotangent. ``one_cell``: every point
    lies in one level-0 cell instead, the most duplicated rows an input can
    have."""
    import torch

    from focnerf_tpu_torch.ops import hashgrid as thg

    dev = torch.device("cuda")
    spec = cfg.grid_spec
    g = torch.Generator(device="cuda").manual_seed(2)
    x01 = ray_points01(cfg, samples, g, n)
    if one_cell:  # level 0's cell [8, 9)^3 of pos = x * scale + 0.5
        scale = thg._level_scale(spec, 0)
        x01 = (7.5 + 0.98 * torch.rand(x01.shape, generator=g, device=dev)) / scale
    u = None
    if stochastic:
        u = torch.rand((x01.shape[0], len(thg.stochastic_levels(spec)), 1, 3), generator=g, device=dev)
    table = torch.zeros((spec.table_rows, spec.level_dim), device=dev)
    _, rows, weights = thg.hashgrid_encode_forward(table, x01, spec, u, residuals=True)
    cot = torch.randn((x01.shape[0], spec.output_dim), generator=g, device=dev)
    return rows, weights, cot, thg.col_levels(spec, stochastic), spec.table_rows


def phase_table_grad_kernel(cfg) -> dict:
    """hashgrid_table_grad (kernel) vs its plain version (index_add_): the
    -O encode at 4096 x 128 and 4096 x 16 points, every point in one
    level-0 cell, the exact layout (8 corners per level), and one channel
    per level (the scalar-atomic path) and four (two float2 atomics a row);
    then timed at the two -O shapes."""
    import dataclasses

    import torch

    from focnerf_tpu_torch.ops import hashgrid as thg
    from focnerf_tpu_torch.utils.measure import device_ms

    cfg1 = dataclasses.replace(cfg, level_dim=1)  # --grid_featdim 1
    cfg4 = dataclasses.replace(cfg, level_dim=4)  # --grid_featdim 4
    cases = {
        "-O 4096x128": (cfg, dict(samples=128)),
        "-O 4096x16": (cfg, dict(samples=16)),
        "one level-0 cell 4096x16": (cfg, dict(samples=16, one_cell=True)),
        "exact 8 corners 4096x16": (cfg, dict(samples=16, stochastic=False)),
        "C=1 -O 4096x128": (cfg1, dict(samples=128)),
        "C=4 -O 4096x16": (cfg4, dict(samples=16)),
    }
    worst = 0.0
    for label, (c, kw) in cases.items():
        rows, weights, cot, cols, n_rows = table_grad_inputs(c, **kw)
        C = c.level_dim
        col_level = torch.tensor(cols, dtype=torch.int32, device=rows.device)
        got = thg.hashgrid_table_grad(rows, weights, cot, cols, n_rows)
        want = thg.table_grad_plain(rows, weights, cot, col_level, n_rows, C)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        rel = float((got - want).abs().max()) / scale
        touched = int((want != 0).any(-1).sum())
        print(f"[kernel] hashgrid_table_grad {label} ({rows.shape[0]} points x {rows.shape[1]} columns, C={C}): "
              f"max_abs_err {rel * scale:.3g}, {rel:.3g} of max|d_table| {scale:.3g}; "
              f"{touched} of {n_rows} rows touched")
        # limit 1e-5 relative: fp32 atomics and warp sums in no fixed order
        if not (rel <= 1e-5 and torch.equal(got == 0, want == 0)):
            raise AssertionError(f"table-gradient kernel disagrees with index_add_ on {label}: {rel}")
        worst = max(worst, rel * scale)
    del rows, weights, cot, got, want

    rows_by_shape = {}
    for samples in (128, 16):
        rows, weights, cot, cols, n_rows = table_grad_inputs(cfg, samples=samples)
        m, J = rows.shape
        C = cfg.level_dim
        col_level = torch.tensor(cols, dtype=torch.int32, device=rows.device)
        contrib = (weights[..., None] * cot.reshape(m, -1, C).index_select(1, col_level)).reshape(-1, C)
        flat_rows = rows.reshape(-1)

        def kernel():
            return thg.hashgrid_table_grad(rows, weights, cot, cols, n_rows)

        def plain():
            return thg.table_grad_plain(rows, weights, cot, col_level, n_rows, C)

        def library():  # index_add_ alone, on contributions made beforehand
            return torch.zeros((n_rows, C), device=rows.device).index_add_(0, flat_rows, contrib)

        with SMClocks() as clocks:
            ms, span = device_ms(kernel)
            plain_ms, plain_span = device_ms(plain)
            lib_ms, lib_span = device_ms(library)
        # bound: read each entry's row and weight (8 B) and the cotangent once,
        # write the whole table gradient once
        nbytes = m * J * 8 + cot.numel() * 4 + n_rows * C * 4 + J * 4
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = m * J * C * 2 / FP32_OPS_PER_S * 1e3
        rows_by_shape[samples] = (ms, plain_ms, lib_ms, max(bytes_ms, ops_ms), bytes_ms >= ops_ms)
        print(f"[kernel] hashgrid_table_grad [{m} points x {J} levels -> {n_rows} x {C}]: device {ms:.5f} ms "
              f"(call span {span:.4f} ms, zero fill included), plain device {plain_ms:.5f} ms "
              f"(span {plain_span:.4f} ms), index_add_ alone {lib_ms:.5f} ms (span {lib_span:.4f} ms), "
              f"bound {max(bytes_ms, ops_ms):.5f} ms ({nbytes} B); {clocks.summary()}")
        # where the kernel's time goes: the zero fill alone, and the kernel
        # with every weight 0 (the tile loads and the fill, no atomics)
        zero_w = torch.zeros_like(weights)
        fill_ms, _ = device_ms(lambda: torch.zeros((n_rows, C), device=rows.device))
        loads_ms, _ = device_ms(lambda: thg.hashgrid_table_grad(rows, zero_w, cot, cols, n_rows))
        print(f"[kernel] hashgrid_table_grad [{m} points] breakdown: zero fill alone {fill_ms:.5f} ms, "
              f"every weight 0 (tile loads + fill, no atomics) {loads_ms:.5f} ms, full kernel {ms:.5f} ms")
        del rows, weights, cot, contrib, flat_rows, zero_w
    ms, plain_ms, lib_ms, bound_ms, by_bytes = rows_by_shape[128]
    return {
        "name": "hashgrid_table_grad",
        "route": "cuda",
        "source": "focnerf_tpu_torch/csrc/hashgrid_bwd.cu",
        "replaces": "focnerf_tpu/ops/hashgrid_pallas.py:126",
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if by_bytes else "operations",
        "library_ms": lib_ms,
    }


def phase_uniform_shapes(cfg) -> list:
    """The kernels at the shapes the uniform and -O2 training paths give
    them, each held against its plain version and timed: the composite
    forward and backward at [4096, 192] (128 samples + 64 importance
    samples) and [4096, 576] (512 + 64), T_thresh 0, normalized ts, a
    quarter of the rays thin; the table gradient on the exact 8-corner layout
    of 4096 x 192 points (J = 128, the uniform path's encode), with
    ``index_add_``'s time, and on half the levels of the -O encode at 4096 x
    128 points (J = 8: one phase of --grad_level_phases 2). Returns the rows
    (label, ms, plain_ms, library_ms or None, bound_ms, max_abs_err)."""
    import torch

    from focnerf_tpu_torch.ops import hashgrid as thg
    from focnerf_tpu_torch.ops.composite import (
        composite_rays,
        composite_rays_fused,
        composite_rays_fused_backward,
        group_width,
    )
    from focnerf_tpu_torch.utils.measure import device_ms

    rows = []
    for t in (192, 576):
        sig, rgb, dts, ts, bg = composite_inputs(t, thin=True)
        ts = ts / ts[:, -1:]
        n = sig.shape[0]
        got = composite_rays_fused(sig, rgb, dts, ts, bg_color=bg, T_thresh=0.0)
        ref = composite_rays(sig, rgb, dts, ts, bg_color=bg, T_thresh=0.0)
        g = torch.Generator(device="cuda").manual_seed(1)
        cot = tuple(torch.randn(sh, generator=g, device="cuda") for sh in ((n, 3), (n,), (n,)))

        def kernel_bwd():
            return composite_rays_fused_backward(sig, rgb, dts, ts, bg, got, cot, T_thresh=0.0)

        def plain_bwd():
            s_, c_ = sig.detach().requires_grad_(), rgb.detach().requires_grad_()
            out = composite_rays(s_, c_, dts, ts, bg_color=bg, T_thresh=0.0)
            return torch.autograd.grad((out["image"], out["weights_sum"], out["depth"]), (s_, c_), cot)

        dk, dp = kernel_bwd(), plain_bwd()
        torch.cuda.synchronize()
        if not all(torch.isfinite(a).all() for a in (*got, *dk)):
            raise AssertionError(f"composite kernels: non-finite output at T={t}")
        f_err = max(float((a - b).abs().max()) for a, b in zip(got, (ref["image"], ref["weights_sum"], ref["depth"])))
        b_err = max(float((a - b).abs().max()) for a, b in zip(dk, dp))
        ms, _ = device_ms(lambda: composite_rays_fused(sig, rgb, dts, ts, bg_color=bg, T_thresh=0.0))
        plain_ms, _ = device_ms(lambda: composite_rays(sig, rgb, dts, ts, bg_color=bg, T_thresh=0.0))
        bms, _ = device_ms(kernel_bwd)
        bplain_ms, _ = device_ms(plain_bwd)
        # bytes, as phase 3's rows: every sample read (T_thresh 0), the
        # per-ray background and outputs; the backward also writes 16 B a
        # sample and reads the saved outputs and cotangents
        f_bound = (n * t * 24 + n * 32) / HBM_BYTES_PER_S * 1e3
        b_bound = (n * t * 24 + n * 52 + n * t * 16) / HBM_BYTES_PER_S * 1e3
        print(f"[kernel-uniform] composite_rays_fused [{n},{t}] T_thresh=0, {group_width(t)} lanes per ray, "
              f"{t // group_width(t)} chunks a ray: max_abs_err {f_err:.3g} (limit 1e-5), device {ms:.5f} ms, "
              f"plain {plain_ms:.5f} ms, bound {f_bound:.5f} ms (bytes)")
        print(f"[kernel-uniform] composite_rays_fused_backward [{n},{t}] T_thresh=0: max_abs_err {b_err:.3g} "
              f"(limit 1e-5), device {bms:.5f} ms, plain (forward + autograd) {bplain_ms:.5f} ms, bound "
              f"{b_bound:.5f} ms (bytes)")
        if not (f_err <= 1e-5 and b_err <= 1e-5):
            raise AssertionError(f"composite kernels disagree with their plain versions at T={t}: {f_err} {b_err}")
        rows += [(f"composite_rays_fused [{n},{t}]", ms, plain_ms, None, f_bound, f_err),
                 (f"composite_rays_fused_backward [{n},{t}]", bms, bplain_ms, None, b_bound, b_err)]
        del sig, rgb, dts, ts, bg, got, ref, dk, dp

    cases = (("exact 8 corners 4096x192", dict(samples=192, stochastic=False), None),
             ("-O2 half the levels 4096x128", dict(samples=128), 0))
    for label, kw, phase in cases:
        rows_t, weights, cot, cols, n_rows = table_grad_inputs(cfg, **kw)
        if phase is not None:  # the live columns of phase 0 of 2, as HashGridEncode selects them
            live = [j for j, lvl in enumerate(cols) if lvl % 2 == phase]
            sel = torch.tensor(live, device=rows_t.device)
            rows_t, weights = rows_t.index_select(1, sel).contiguous(), weights.index_select(1, sel).contiguous()
            cols = tuple(cols[j] for j in live)
        m, J = rows_t.shape
        C = cfg.level_dim
        col_level = torch.tensor(cols, dtype=torch.int32, device=rows_t.device)
        got = thg.hashgrid_table_grad(rows_t, weights, cot, cols, n_rows, level_dim=C)
        want = thg.table_grad_plain(rows_t, weights, cot, col_level, n_rows, C)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        if not (err <= 1e-5 * scale and torch.equal(got == 0, want == 0)):
            raise AssertionError(f"table-gradient kernel disagrees with index_add_ on {label}: {err / scale}")
        contrib = (weights[..., None] * cot.reshape(m, -1, C).index_select(1, col_level)).reshape(-1, C)
        flat = rows_t.reshape(-1)
        ms, _ = device_ms(lambda: thg.hashgrid_table_grad(rows_t, weights, cot, cols, n_rows, level_dim=C))
        plain_ms, _ = device_ms(lambda: thg.table_grad_plain(rows_t, weights, cot, col_level, n_rows, C))
        lib_ms, _ = device_ms(lambda: torch.zeros((n_rows, C), device=flat.device).index_add_(0, flat, contrib))
        nbytes = m * J * 8 + cot.numel() * 4 + n_rows * C * 4 + J * 4
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"[kernel-uniform] hashgrid_table_grad {label} ({m} points x {J} columns, levels "
              f"{sorted(set(cols))}): max_abs_err {err:.3g} ({err / scale:.3g} of max|d_table|, limit 1e-5), "
              f"device {ms:.5f} ms, plain {plain_ms:.5f} ms, index_add_ alone {lib_ms:.5f} ms, bound "
              f"{bound:.5f} ms ({nbytes} B)")
        rows.append((f"hashgrid_table_grad {label}", ms, plain_ms, lib_ms, bound, err))
        del rows_t, weights, cot, got, want, contrib, flat
    return rows


# the encode kernels against their plain versions on the card: rows bit for
# bit; weights to ENCODE_W_REL relative + ENCODE_W_ABS (a few ulp: the D
# factors multiplied in another order than torch's prod); out to
# ENCODE_OUT_ABS of the table's largest |value| (2^D or K products summed in
# another order); the position gradient to ENCODE_GX_REL relative L2
ENCODE_W_REL, ENCODE_W_ABS, ENCODE_OUT_ABS, ENCODE_GX_REL = 1e-6, 1e-7, 1e-6, 1e-5


def encode_points(spec, x, g):
    """A copy of the points ``x`` [N, D] (on the card) with a twentieth moved
    outside the unit cube and, on every level, N / (4 L) given one coordinate
    on a cell face of that level (pos = x * scale + 0.5 on an integer) or one
    ulp beside it: where a cell changes, the rows must still match."""
    import torch

    from focnerf_tpu_torch.ops.hashgrid import _level_scale

    x = x.clone()
    n, D = x.shape
    dev = x.device
    k, m = n // 20, n // 4 // spec.num_levels
    x[:k] = torch.rand((k, D), generator=g, device=dev) * 2 - 0.5
    i = k
    for lvl in range(spec.num_levels):
        scale = _level_scale(spec, lvl)
        f = ((torch.randint(1, max(int(scale), 2), (m,), generator=g, device=dev).double() - 0.5) / scale).float()
        side = torch.randint(0, 3, (m,), generator=g, device=dev)
        f = torch.where(side == 1, torch.nextafter(f, torch.full_like(f, 2.0)), f)
        f = torch.where(side == 2, torch.nextafter(f, torch.full_like(f, -1.0)), f)
        x[torch.arange(i, i + m, device=dev), torch.randint(0, D, (m,), generator=g, device=dev)] = f
        i += m
    return x


def _bound(nbytes: float, ops: float):
    """(bound ms, "bytes" or "operations") on the H100 SXM's peaks."""
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def sector_bound_ms(spec, n: int, corners: int, l2_bytes_per_s: float) -> float:
    """The least time the gathers of ``corners`` corners a level take
    through L2 on n points: one 32-byte sector for every corner read on a
    hashed level (its 8 bytes lie at a random row), over the card's L2 read
    rate (``utils/measure.l2_read_bytes_per_s``)."""
    return n * sum(spec.hashed) * corners * 32 / l2_bytes_per_s * 1e3


def encode_check(label: str, spec, x, table, u=None, residuals: bool = True, select=None, time_it: bool = False,
                 l2_rate: float = 0.0):
    """``hashgrid_encode_forward`` (the kernel) against ``encode_plain`` on
    the card on the same operands, with and without residuals: rows bit for
    bit (``select``: the grad_levels columns HashGridEncode keeps, taken from
    both), weights and out to the limits above, out equal with and without
    residuals, outside points at weight and value 0. ``time_it``: the kernel
    (``residuals`` as the main path asks) warm and with L2 flushed, the
    plain version and the bounds: bytes (each point's coordinates and draws
    read, each table row it touches read once, out and the residuals
    written) and the hashed corner reads' L2 sectors at ``l2_rate``. Returns
    the numbers."""
    import torch

    from focnerf_tpu_torch.ops import hashgrid as thg
    from focnerf_tpu_torch.utils.measure import device_ms, kernel_ms

    out, rows, weights = thg.hashgrid_encode_forward(table, x, spec, u, residuals=True)
    bare, _, _ = thg.hashgrid_encode_forward(table, x, spec, u, residuals=False)
    pout, prows, pweights = thg.encode_plain(table, x, spec, u, residuals=True)
    if select is not None:
        rows, weights, prows, pweights = (t.index_select(1, select) for t in (rows, weights, prows, pweights))
    torch.cuda.synchronize()
    oob = ((x < 0) | (x > 1)).any(-1)
    rows_equal = torch.equal(rows, prows)
    w_ok = bool(((weights - pweights).abs() <= ENCODE_W_ABS + ENCODE_W_REL * pweights.abs()).all())
    w_err = float((weights - pweights).abs().max())
    err = float((out - pout).abs().max())
    limit = ENCODE_OUT_ABS * float(table.abs().max())
    zero = bool((weights[oob] == 0).all() and (out[oob] == 0).all())
    n, J = rows.shape
    res = {"err": err, "points": n, "columns": J}
    line = (f"[kernel-encode] hashgrid_encode_forward {label} [{n} points, D={spec.input_dim}, {spec.num_levels} "
            f"levels, J={J}]: rows {'equal bit for bit' if rows_equal else 'DIFFER'} "
            f"({int((rows != prows).any(-1).sum())} points differ; {int(oob.sum())} outside the cube), weights "
            f"max_abs_err {w_err:.3g} (limit {ENCODE_W_REL:g} relative + {ENCODE_W_ABS:g}), out max_abs_err {err:.3g} "
            f"(limit {limit:.3g})")
    if time_it:
        def call():
            thg.hashgrid_encode_forward(table, x, spec, u, residuals=residuals)

        with SMClocks() as clocks:
            ms, events = kernel_ms(call, thg.ENCODE_KERNEL)
            cold_ms, cold_events = kernel_ms(call, thg.ENCODE_KERNEL, flush=True)
            plain_ms, _ = device_ms(lambda: thg.encode_plain(table, x, spec, u, residuals=residuals), iters=10)
        L, C, D = spec.num_levels, spec.level_dim, spec.input_dim
        touched = int(torch.unique(rows).numel())
        nbytes = (n * D * 4 + (0 if u is None else u.numel() * 4) + touched * C * 4 + n * L * C * 4
                  + (n * J * 8 if residuals else 0))
        bound_ms, by = _bound(nbytes, n * J * (D + 2 * C) + n * L * D * 3)
        sectors_ms = sector_bound_ms(spec, n, spec.stochastic_k if u is not None else 1 << D, l2_rate)
        res.update(ms=ms, cold_ms=cold_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by, sectors_ms=sectors_ms)
        line += (f"; device {ms:.5f} ms warm ({events} kernel events over 100 calls, residuals "
                 f"{'on' if residuals else 'off'}), {cold_ms:.5f} ms with L2 flushed ({cold_events} events), plain "
                 f"{plain_ms:.5f} ms, bound {bound_ms:.5f} ms ({by}, {nbytes} B, {touched} table rows touched), L2 "
                 f"sectors {sectors_ms:.5f} ms; {clocks.summary()}")
    print(line)
    if not (rows_equal and w_ok and err <= limit and zero and torch.equal(out, bare)):
        raise AssertionError(f"encode kernel disagrees with encode_plain: {label}")
    return res


def input_grad_check(label: str, spec, x, table, g, time_it: bool = False, l2_rate: float = 0.0):
    """``hashgrid_input_grad`` (the kernel, which recomputes the rows from
    the points) against ``input_grad_plain`` on the card: ENCODE_GX_REL rel
    L2, two runs equal bit for bit, 0 outside the cube. ``time_it``: the
    kernel warm and with L2 flushed, the plain version, and the bounds:
    bytes (coordinates and cotangent read, each table row touched once,
    counted from the forward kernel's rows, the gradient written) and the
    hashed corner reads' L2 sectors at ``l2_rate``."""
    import torch

    from focnerf_tpu_torch.ops import hashgrid as thg
    from focnerf_tpu_torch.utils.measure import device_ms, kernel_ms

    n, D = x.shape
    L, C = spec.num_levels, spec.level_dim
    cot = torch.randn((n, L * C), generator=g, device=x.device)
    got = thg.hashgrid_input_grad(table, x, cot, spec)
    again = thg.hashgrid_input_grad(table, x, cot, spec)
    want = thg.input_grad_plain(table, x, cot, spec)
    torch.cuda.synchronize()
    oob = ((x < 0) | (x > 1)).any(-1)
    rel = float((got - want).norm() / want.norm())
    res = {"err": float((got - want).abs().max()), "rel": rel}
    line = (f"[kernel-encode] hashgrid_input_grad {label} [{n} points, D={D}, {L} levels x {1 << D} corners]: "
            f"rel L2 {rel:.3g} (limit {ENCODE_GX_REL:g}), max_abs_err {res['err']:.3g} of max|dL/dx| "
            f"{float(want.abs().max()):.3g}; two runs {'equal' if torch.equal(got, again) else 'DIFFER'}")
    if time_it:
        def call():
            thg.hashgrid_input_grad(table, x, cot, spec)

        with SMClocks() as clocks:
            ms, events = kernel_ms(call, thg.INPUT_GRAD_KERNEL)
            cold_ms, cold_events = kernel_ms(call, thg.INPUT_GRAD_KERNEL, flush=True)
            plain_ms, _ = device_ms(lambda: thg.input_grad_plain(table, x, cot, spec), iters=5)
        _, rows, _ = thg.hashgrid_encode_forward(table, x, spec, None, residuals=True)
        J = rows.shape[1]
        touched = int(torch.unique(rows).numel())
        del rows
        nbytes = n * D * 4 + cot.numel() * 4 + touched * C * 4 + n * D * 4
        bound_ms, by = _bound(nbytes, n * J * (2 * C + D * D + 3 * D))
        sectors_ms = sector_bound_ms(spec, n, 1 << D, l2_rate)
        res.update(ms=ms, cold_ms=cold_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by, sectors_ms=sectors_ms)
        line += (f"; device {ms:.5f} ms warm ({events} kernel events over 100 calls), {cold_ms:.5f} ms with L2 "
                 f"flushed ({cold_events} events), plain {plain_ms:.5f} ms, bound {bound_ms:.5f} ms ({by}, {nbytes} B, "
                 f"{touched} table rows touched), L2 sectors {sectors_ms:.5f} ms; {clocks.summary()}")
    print(line)
    if not (rel <= ENCODE_GX_REL and torch.equal(got, again) and bool((got[oob] == 0).all())):
        raise AssertionError(f"position-gradient kernel disagrees with input_grad_plain: {label}")
    return res


def phase_encode_kernel(serve_points: int) -> list:
    """``[kernel-encode]``: the encode kernel and the position-gradient kernel
    against their plain versions on the card, at the main path's full-width
    shapes, each with points on cell faces and outside the cube
    (``encode_points``) and a U(-1, 1) table: the -O training encode
    (4096 x 128 points, K 1 on all 16 levels, residuals on; timed), the
    exact serving encode at ``serve_points`` (the most points one 4096-ray
    ladder chunk of phase 4 encoded; residuals off, as serving asks; timed),
    one -O2 c2f stage (8 levels, grad_levels 1, 3, 5, 7), the background
    grid (D = 2, one chunk's 4096 rays), D-NeRF's deform field (D = 3) and
    hyper field (D = 5) at 4096 x 128 points, each with the position
    gradient (both timed, and deform's forward with residuals; the kernels
    line takes deform's gradient). Each timed kernel is read warm and with
    L2 flushed, beside its byte bound and the L2 sectors its hashed corner
    reads take at the card's measured L2 read rate. Returns the kernels
    line's two entries."""
    import dataclasses

    import torch

    from focnerf_tpu_torch.config import parse_options
    from focnerf_tpu_torch.ops import hashgrid as thg
    from focnerf_tpu_torch.utils.measure import l2_read_bytes_per_s

    dev = torch.device("cuda")
    g = torch.Generator(device="cuda").manual_seed(17)
    l2_rate = l2_read_bytes_per_s(40 * 2**20, dev)
    print(f"[kernel-encode] L2 read rate {l2_rate / 1e12:.3f} TB/s (a 40 MiB buffer read 50 times from L2)")

    def table_for(spec):
        return torch.rand((spec.table_rows, spec.level_dim), generator=g, device=dev) * 2 - 1

    def draws(spec, n):
        return torch.rand((n, len(thg.stochastic_levels(spec)), spec.stochastic_k, spec.input_dim), generator=g,
                          device=dev)

    cfg = parse_options(["scene", "-O"]).nerf_config()
    spec = cfg.grid_spec
    table = table_for(spec)
    x = encode_points(spec, ray_points01(cfg, 128, g), g)
    train = encode_check(f"-O training encode (K {spec.stochastic_k} on every level)", spec, x, table,
                         draws(spec, x.shape[0]), time_it=True, l2_rate=l2_rate)
    exact = dataclasses.replace(spec, stochastic_k=0, stochastic_min_size=0)
    xs = encode_points(exact, ray_points01(cfg, math.ceil(serve_points / CHUNK), g)[:serve_points], g)
    encode_check("serving exact encode (one ladder chunk's points)", exact, xs, table, residuals=False, time_it=True,
                 l2_rate=l2_rate)
    del xs
    o2 = parse_options(["scene", "-O2"]).nerf_config()
    sub = dataclasses.replace(o2.grid_spec, grad_levels=(1, 3, 5, 7)).truncate(8)
    cols = thg.col_levels(sub, True)
    live = torch.tensor([j for j, lvl in enumerate(cols) if lvl in sub.grad_levels], device=dev)
    encode_check("-O2 c2f stage of 8 levels, grad_levels (1, 3, 5, 7)", sub, x, table[: sub.table_rows],
                 draws(sub, x.shape[0]), select=live)
    del x, table
    bg = cfg.bg_grid_spec
    xb = encode_points(bg, torch.rand((CHUNK, 2), generator=g, device=dev), g)
    encode_check("background grid (one chunk's 4096 rays)", bg, xb, table_for(bg))
    grads = {}
    for name, argv in (("deform", ["scene", "-O"]), ("hyper", ["scene", "-O", "--hyper"])):
        dcfg = parse_options(argv).dnerf_config()
        spec = dcfg.field_spec
        x = ray_points01(dcfg, 128, g)
        if spec.input_dim > 3:  # the hyper field's lifted coordinates, a sigmoid's range
            lifted = torch.sigmoid(torch.randn((x.shape[0], spec.input_dim - 3), generator=g, device=dev))
            x = torch.cat([x, lifted], -1)
        x = encode_points(spec, x, g)
        table = table_for(spec)
        encode_check(f"D-NeRF {name} field", spec, x, table, time_it=name == "deform", l2_rate=l2_rate)
        grads[name] = input_grad_check(f"D-NeRF {name} field", spec, x, table, g, time_it=True, l2_rate=l2_rate)
        del x, table
    common = {"route": "cuda", "source": "focnerf_tpu_torch/csrc/hashgrid_fwd.cu", "library_ms": None}
    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    return [
        {"name": "hashgrid_encode_forward", **common,
         "replaces": "focnerf_tpu/ops/hashgrid.py:360 (_encode_impl, left to XLA; no Pallas kernel)",
         "max_abs_err": train["err"], **{k: train[k] for k in keys}},
        {"name": "hashgrid_input_grad", **common,
         "replaces": "focnerf_tpu/ops/hashgrid.py:462 (JAX autodiff of the input_grads=True encode; no Pallas kernel)",
         "max_abs_err": max(r["err"] for r in grads.values()), **{k: grads["deform"][k] for k in keys}},
    ]


class EncodeCalls:
    """Counts, while the block runs, the encodes the models ask for: every
    call of ``models.nerf``'s and ``models.dnerf``'s hash-encode functions
    (``density_fn``, ``background_fn``, the D-NeRF fields), with each call's
    point count in ``points``. Each such call runs one encode forward."""

    def __enter__(self):
        from focnerf_tpu_torch.models import dnerf, nerf

        self.points = []
        self.patched = [(nerf, "hashgrid_encode_c2f"), (nerf, "hashgrid_encode"), (dnerf, "hashgrid_encode")]
        self.real = [getattr(mod, name) for mod, name in self.patched]
        for (mod, name), real in zip(self.patched, self.real):
            setattr(mod, name, self._recording(real))
        return self

    def _recording(self, real):
        def encode(table, x01, *args, **kwargs):
            self.points.append(x01.numel() // x01.shape[-1])
            return real(table, x01, *args, **kwargs)

        return encode

    def __exit__(self, *exc):
        for (mod, name), real in zip(self.patched, self.real):
            setattr(mod, name, real)


def check_encodes(tag: str, launches: dict, at_least: int, position: int = 0):
    """The encode kernel launched at least ``at_least`` times on a path that
    encodes, the position-gradient kernel exactly ``position`` times (once a
    D-NeRF deform or hyper step; 0 on every other path)."""
    enc, pos = launches["hashgrid_encode_forward"], launches["hashgrid_input_grad"]
    if not (enc >= at_least and pos == position):
        raise AssertionError(f"{tag}: the encode kernel launched {enc} times (want at least {at_least}), the "
                             f"position-gradient kernel {pos} (want {position})")


def _ngp_to_nerf(ngp, scale: float):
    """Inverse of nerf_matrix_to_ngp at ``scale`` and zero offset."""
    import numpy as np

    out = np.eye(4, dtype=np.float32)
    for dst, src in ((1, 0), (2, 1), (0, 2)):
        out[dst, :3] = ngp[src, :3] * np.array([1, -1, -1])
        out[dst, 3] = ngp[src, 3] / scale
    return out


def write_scene(root: str, scale: float = 0.33, radius: float = 4.0):
    """Blender-layout test split: VIEWS RGBA views of RES^2 on a sphere of
    ``radius`` around the origin, and a train-pose feature sidecar."""
    import numpy as np

    from focnerf_tpu_torch.core.camera import rand_poses
    from focnerf_tpu_torch.data.png import write_image

    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "test"), exist_ok=True)
    yy, xx = np.mgrid[0:RES, 0:RES]
    frames = []
    for i, pose in enumerate(rand_poses(rng, VIEWS, radius=radius)):
        img = np.stack([xx % 256, yy % 256, (xx + yy) % 256, np.full_like(xx, 255)], -1)
        write_image(os.path.join(root, "test", f"r_{i}.png"), img.astype(np.uint8))
        frames.append({"file_path": f"test/r_{i}", "transform_matrix": _ngp_to_nerf(pose, scale).tolist()})
    fov_x = 2 * math.atan(1 / 2.4)  # focal = 1.2 * width
    with open(os.path.join(root, "transforms_test.json"), "w") as f:
        json.dump({"camera_angle_x": fov_x, "frames": frames}, f)
    return rand_poses(rng, 8, radius=radius)


def write_checkpoint(ws: str, train_poses, opt, dev):
    """A port checkpoint of ``seeded_model`` and the object-feature sidecar."""
    import numpy as np

    from focnerf_tpu_torch.data.feats import save_obj_feats
    from focnerf_tpu_torch.ops.occupancy import occupancy_bitfield
    from focnerf_tpu_torch.train.checkpoints import CheckpointManager, save_model_config
    from focnerf_tpu_torch.utils.measure import seeded_model

    params, cfg, occ = seeded_model(opt, dev)
    share = float(occupancy_bitfield(occ, opt.density_thresh).float().mean())
    print(f"[main] checkpoint: {cfg.grid_spec.table_rows} table rows x {cfg.level_dim}, "
          f"{occ.density_grid.shape[0]} cascades, occupied share {share:.4f}")
    ckpt = os.path.join(f"{ws}_background", "checkpoints")
    save_model_config(ckpt, cfg)
    CheckpointManager(ckpt).save({"step": 0, "params": params, "ema_params": params}, occ)
    feats = np.random.default_rng(1).normal(size=(len(train_poses), 144)).astype(np.float32)
    save_obj_feats(os.path.join(ws, "obj_feats", "background.npz"), feats, train_poses)
    return params, cfg, occ


def check_renders(results: str, views: int):
    from focnerf_tpu_torch.data.png import read_image

    for v in range(views):
        img = read_image(os.path.join(results, f"ngp_{v:04d}.png"))
        if img.shape != (RES, RES, 3):
            raise AssertionError(f"view {v}: render of shape {img.shape}")
        if not os.path.exists(os.path.join(results, f"ngp_{v:04d}_depth.png")):
            raise AssertionError(f"view {v}: no depth render")


def phase_serving(work: str, dev):
    import torch

    from focnerf_tpu_torch.apps import main_nerf
    from focnerf_tpu_torch.config import parse_options
    from focnerf_tpu_torch.ops.occupancy import occupancy_bitfield

    scene, ws = os.path.join(work, "scene"), os.path.join(work, "ws")
    argv = [scene, "--test", "-O", "--workspace", ws, "--disable_yolo"]
    opt = parse_options(argv)
    train_poses = write_scene(scene, scale=opt.scale)
    params, cfg, occ = write_checkpoint(ws, train_poses, opt, dev)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    with EncodeCalls() as encodes:
        main_nerf.main(argv, device=dev)
        torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_counts()

    check_renders(os.path.join(f"{ws}_background", "results"), VIEWS)
    chunks = VIEWS * math.ceil(RES * RES / CHUNK)
    want = dict(composite_rays_fused=chunks, composite_rays_resume=0, composite_rays_fused_backward=0,
                hashgrid_table_grad=0, march_rays_skip=0, hashgrid_encode_forward=len(encodes.points),
                hashgrid_input_grad=0)
    if launches != want or len(encodes.points) < chunks:
        raise AssertionError(f"serving launches {launches}, want {want} (at least one encode a chunk)")
    print(f"[serve] main_nerf --test -O: {VIEWS} views of {RES}x{RES} in {wall:.2f} s "
          f"({wall / VIEWS:.3f} s/view, first view includes warm-up), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, launches {launches}; points an encode: mean "
          f"{sum(encodes.points) / len(encodes.points):.0f}, most {max(encodes.points)}")
    return params, cfg, occupancy_bitfield(occ, opt.density_thresh), max(encodes.points)


def sphere_view(pose, fl: float, spheres=(SPHERE,), res: int = RES):
    """RGBA render [res, res, 4] uint8 of analytic spheres (``(centre,
    radius, colour below, colour above)``: one colour where y < 0, another
    above) for an ngp pose, the nearest hit in front; transparent around
    them, as a Blender object render is."""
    import numpy as np

    yy, xx = np.mgrid[0:res, 0:res].astype(np.float32)
    dirs = np.stack([(xx + 0.5 - res / 2) / fl, (yy + 0.5 - res / 2) / fl, np.ones_like(xx)], -1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    d = dirs.reshape(-1, 3) @ pose[:3, :3].T
    t_near = np.full(d.shape[0], np.inf)
    rgb = np.ones_like(d)
    for centre, radius, below, above in spheres:
        o = pose[:3, 3] - np.asarray(centre, np.float32)
        b = d @ o
        disc = b * b - (o @ o - radius**2)
        t = -b - np.sqrt(np.maximum(disc, 0))
        hit = (disc > 0) & (t > 0) & (t < t_near)
        y = o[1] + t * d[:, 1]
        rgb = np.where(hit[:, None], np.where((y < 0)[:, None], [below], [above]), rgb)
        t_near = np.where(hit, t, t_near)
    rgba = np.concatenate([rgb, np.isfinite(t_near)[:, None]], -1)
    return (rgba.reshape(res, res, 4) * 255 + 0.5).astype(np.uint8)


def write_training_scene(root: str, scale: float, obj: str = OBJECT, spheres=(SPHERE,), feat: float = 0.0,
                         splits=("train", "val", "test"), radius: float = CAMERA_RADIUS, val_views: int = VAL_VIEWS):
    """Blender-layout ``splits`` of analytic spheres at RES^2 (focal 1.2 *
    width), cameras on a sphere of CAMERA_RADIUS (ngp units) looking at the
    origin, and the object-mask sidecar that YOLO preprocessing would write
    (``yolo/<split>.npz``: one object, ``obj``, masked by the spheres' alpha,
    the feature ``feat`` in all 144 entries of every view). FOC-NeRF takes an
    object's alpha from its mask, so the mask is what makes the pixels
    around the object transparent in training. Every scene draws the same
    cameras (train, then val, then test) on a sphere of ``radius``,
    whichever splits it writes; the val split keeps the first
    ``val_views``."""
    import numpy as np

    from focnerf_tpu_torch.core.camera import rand_poses
    from focnerf_tpu_torch.data.png import write_image

    rng = np.random.default_rng(7)
    os.makedirs(os.path.join(root, "yolo"), exist_ok=True)
    for split, n in (("train", TRAIN_VIEWS), ("val", VAL_VIEWS), ("test", VIEWS)):
        poses = rand_poses(rng, n, radius=radius)
        if split not in splits:
            continue
        if split == "val":
            poses = poses[:val_views]
            n = len(poses)
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames, paths, masks = [], [], []
        for i, pose in enumerate(poses):
            rgba = sphere_view(pose, 1.2 * RES, spheres)
            paths.append(f"{split}/r_{i}.png")
            write_image(os.path.join(root, paths[-1]), rgba)
            masks.append(rgba[..., 3] > 127)
            frames.append({"file_path": f"{split}/r_{i}",
                           "transform_matrix": _ngp_to_nerf(pose, scale).tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 2 * math.atan(1 / 2.4), "frames": frames}, f)
        np.savez_compressed(
            os.path.join(root, "yolo", f"{split}.npz"), names=[obj], paths=np.array(paths),
            **{f"{obj}__masks": np.stack(masks), f"{obj}__feats": np.full((n, 144), feat, np.float32),
               f"{obj}__bboxes": np.full((n, 4), -1.0, np.float32)},
        )


def phase_train(work: str, dev):
    """main_nerf -O training at full width with its default eval renderer
    (iter), then --test -O from its checkpoint."""
    import numpy as np
    import torch

    from focnerf_tpu_torch.apps import main_nerf
    from focnerf_tpu_torch.config import parse_options
    from focnerf_tpu_torch.render.iterative import render_rays_iterative
    from focnerf_tpu_torch.train.checkpoints import CheckpointManager

    scene, ws = os.path.join(work, "train_scene"), os.path.join(work, "train_ws")
    argv = [scene, "-O", "--workspace", ws, "--disable_yolo", "--iters", str(TRAIN_ITERS),
            "--mesh_res", "0", "--ckpt_interval", "10"]
    opt = parse_options(argv)
    t0 = time.time()
    write_training_scene(scene, opt.scale)
    print(f"[train] scene: {TRAIN_VIEWS} train, {VAL_VIEWS} val, {VIEWS} test views of "
          f"{RES}x{RES} written in {time.time() - t0:.1f} s")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    render_rays_iterative.rounds = 0
    t0 = time.time()
    with SMClocks() as clocks:
        (trainer,) = main_nerf.main(argv, device=dev)
        torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_counts()
    rounds = render_rays_iterative.rounds
    peak = torch.cuda.max_memory_allocated() / 2**30

    steps = len(trainer.step_losses)
    with open(os.path.join(ws, "train_times.txt")) as f:
        train_s = float(f.read().split(":")[1].split("s")[0])
    losses = np.asarray(trainer.step_losses)
    first, last = float(losses[:50].mean()), float(losses[-50:].mean())
    psnr = trainer.last_eval_results["PSNR"]
    ckpt = CheckpointManager(os.path.join(f"{ws}_{OBJECT}", "checkpoints")).latest_step()
    print(f"[train] main_nerf -O --iters {TRAIN_ITERS}: {steps} steps of {opt.num_rays} rays in "
          f"{train_s:.2f} s of training ({wall:.2f} s with loading and the final eval): "
          f"{train_s / steps * 1e3:.2f} ms/step, {opt.num_rays * steps / train_s:.0f} rays/s, "
          f"peak memory {peak:.3f} GiB; {clocks.summary()}")
    print(f"[train] loss first 50 steps {first:.5f}, last 50 {last:.5f}; val PSNR {psnr:.3f} dB "
          f"({trainer.eval_renderer} eval, {rounds} rounds over {VAL_VIEWS} views), "
          f"SSIM {trainer.last_eval_results['SSIM']:.4f}; slab {trainer.active_slab}; skip-walk "
          f"iterations per step mean {np.mean(trainer.march_iters):.1f} "
          f"(max {max(trainer.march_iters)}); launches {launches}; checkpoint step {ckpt}")
    if launches["hashgrid_table_grad"] != steps or launches["composite_rays_fused_backward"] != steps:
        raise AssertionError(f"backward kernels launched {launches}, want once per step ({steps})")
    if launches["composite_rays_fused"] < steps:
        raise AssertionError(f"composite forward launched {launches} times in {steps} steps")
    if launches["march_rays_skip"] != steps + rounds:
        raise AssertionError(f"march_rays_skip launched {launches['march_rays_skip']} times, want once a step "
                             f"({steps}) and once an eval round ({rounds})")
    check_encodes("training", launches, steps + rounds)  # a step's, an eval round's and the occupancy updates'
    if trainer.eval_renderer != "iter" or not launches["composite_rays_resume"] == rounds > 0:
        raise AssertionError(f"the {trainer.eval_renderer} eval ran {rounds} rounds, launches {launches}; "
                             "want the iterative renderer, one composite_rays_resume launch a round")
    if steps != TRAIN_ITERS or not np.isfinite(losses).all() or not last < 0.5 * first:
        raise AssertionError(f"training did not learn: {steps} steps, loss {first} -> {last}")
    if not psnr >= 20.0:
        raise AssertionError(f"val PSNR {psnr} dB after {steps} steps, want >= 20")
    if ckpt != TRAIN_ITERS:
        raise AssertionError(f"latest checkpoint at step {ckpt}, want {TRAIN_ITERS}")

    # serving from the trained checkpoint: a trained, sparse grid
    reset_counts()
    t0 = time.time()
    main_nerf.main([scene, "--test", "-O", "--workspace", ws, "--disable_yolo"], device=dev)
    torch.cuda.synchronize()
    serve_s = time.time() - t0
    served = read_counts()
    check_renders(os.path.join(f"{ws}_{OBJECT}", "results"), VIEWS)
    want = VIEWS * math.ceil(RES * RES / CHUNK)
    if served["composite_rays_fused"] != want:
        raise AssertionError(f"trained serving launched {served}, want {want} composites")
    check_encodes("trained serving", served, want)
    print(f"[train] main_nerf --test -O from the trained checkpoint: {VIEWS} views in {serve_s:.2f} s "
          f"({serve_s / VIEWS:.3f} s/view), launches {served}")
    return launches, trainer


MARCH_SLABS = (128, 32, 16)  # the -O slab buckets [kernel-march] holds the kernel at
ITER_RAYS, ITER_SUB_SLAB, ITER_MAX_ITERS = 65536, 16, 24  # the iterative eval round's march


def march_check(tag: str, rays_o, rays_d, nears, fars, skip, time_it: bool = False, plain_iters: int = 3,
                load_ns: float = 0.0, **kw):
    """The skip-walk kernel against the plain walk on the same inputs: ts,
    dts, valid and count must be equal bit for bit. With ``time_it``: the
    kernel's own device time (without the wrapper's jitter and zero fill),
    the plain walk's (device and span: its host reads
    every 4 iterations are in the span), the byte bound (each ray's inputs,
    one skip byte per iteration the rays run, the [N, slab] outputs at
    HBM_BYTES_PER_S) and the latency bound (the longest ray's leaps + 1
    dependent reads at ``load_ns`` each: a leap's landing depends on its
    read). Returns a dict of the numbers."""
    import torch

    from focnerf_tpu_torch.ops.marching import march_rays_skip, march_skip_plain
    from focnerf_tpu_torch.utils.measure import device_ms, kernel_ms

    got = march_rays_skip(rays_o, rays_d, nears, fars, skip, **kw)
    want = march_skip_plain(rays_o, rays_d, nears, fars, skip, **kw)
    torch.cuda.synchronize()
    same = {name: torch.equal(getattr(got, name), getattr(want, name)) for name in ("ts", "dts", "valid", "count")}
    err = float((got.ts - want.ts).abs().max())
    n, slab = got.ts.shape
    walked = int(got.ray_iters.sum())
    leaps = got.ray_iters.long() - got.count
    out = {"err": err, "rays": n, "slab": slab, "mean_count": float(got.count.float().mean()),
           "mean_leaps": float(leaps.float().mean()), "max_leaps": int(leaps.max()),
           "iters": int(got.iters), "plain_iters": want.iters, "walked": walked}
    if not all(same.values()):
        r = int((got.ts != want.ts).any(-1).nonzero()[0]) if not same["ts"] else -1
        raise AssertionError(f"[kernel-march] {tag}: kernel and plain walk differ {same} (max |ts| error {err}; "
                             f"first ray {r})")
    if int(got.iters) != int(got.ray_iters.max()) or bool((leaps < 0).any()):
        raise AssertionError(f"[kernel-march] {tag}: iters {int(got.iters)}, ray_iters max "
                             f"{int(got.ray_iters.max())}, fewer iterations than samples {int((leaps < 0).sum())}")
    line = (f"[kernel-march] march_rays_skip {tag} [{n} rays, slab {slab}]: ts, dts, valid, count equal bit for "
            f"bit; mean samples {out['mean_count']:.1f} and leaps {out['mean_leaps']:.1f} a ray (most leaps "
            f"{out['max_leaps']}), longest walk {out['iters']} iterations (plain walk {want.iters}), {walked} "
            "iterations over all rays")
    if time_it:
        ms, events = kernel_ms(lambda: march_rays_skip(rays_o, rays_d, nears, fars, skip, **kw), "march_skip_kernel")
        _, span = device_ms(lambda: march_rays_skip(rays_o, rays_d, nears, fars, skip, **kw))
        plain_ms, plain_span = device_ms(lambda: march_skip_plain(rays_o, rays_d, nears, fars, skip, **kw),
                                         iters=plain_iters)
        nbytes = n * 32 + walked + n * (9 * slab + 12)
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        latency_ms = (out["max_leaps"] + 1) * load_ns * 1e-6
        out.update(ms=ms, span=span, plain_ms=plain_ms, plain_span=plain_span, bytes=nbytes, bound_ms=byte_ms,
                   latency_bound_ms=latency_ms, walk_bound_ms=max(byte_ms, latency_ms),
                   walk_bound_by="latency" if latency_ms > byte_ms else "bytes")
        line += (f"; kernel {ms:.5f} ms ({events} of 100 launches traced; call span {span:.4f} ms), plain walk "
                 f"device {plain_ms:.4f} ms (span "
                 f"{plain_span:.2f} ms); bounds: bytes {byte_ms:.5f} ms ({nbytes} B), latency "
                 f"{latency_ms:.5f} ms ({out['max_leaps'] + 1} dependent reads x {load_ns:.1f} ns), bound by "
                 f"{out['walk_bound_by']} ({ms / out['walk_bound_ms']:.1f}x the bound)")
    print(line)
    return out


def march_cases(trainer, ds, val_ds, dev) -> list:
    """``[kernel-march]``'s inputs on phase 5's trained skip field, as
    (tag, (rays_o, rays_d, nears, fars, skip), kw, timed): the -O training
    shape (4096 rays of a batch, dt_gamma 1/128, the start jittered) at the
    slabs MARCH_SLABS, timed at 128 and 16; the iterative eval round's start
    (no jitter: ITER_RAYS rays of a val view from their near, the view's
    middle rows, through the object; timed), then from where their first
    round stopped, sub-slab ITER_SUB_SLAB, and once more under a cap of
    ITER_MAX_ITERS."""
    import torch

    from focnerf_tpu_torch.core.geometry import near_far_from_aabb
    from focnerf_tpu_torch.ops.marching import march_rays_skip
    from focnerf_tpu_torch.render.renderer import default_aabb, padded_rays

    cfg = trainer.cfg
    skip = trainer._occ_bits_for_batch()
    aabb = default_aabb(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(14)
    batch = ds.train_batch(gen)
    o, d = batch["rays_o"], batch["rays_d"]
    near, far = near_far_from_aabb(o, d, aabb, trainer.min_near)
    noise = torch.rand(o.shape[0], generator=gen, device=dev)
    kw = dict(bound=cfg.bound, dt_gamma=trainer.dt_gamma, max_steps=trainer.max_steps)
    cases = [(f"-O training batch, jittered, dt_gamma {trainer.dt_gamma:g}", (o, d, near, far, skip),
              dict(kw, noise=noise, slab=slab), slab in (128, 16)) for slab in MARCH_SLABS]
    ro, rd = padded_rays(val_ds.poses[0], val_ds.intrinsics, val_ds.H, val_ds.W, ITER_RAYS, dev)
    mid = (val_ds.H * val_ds.W - ITER_RAYS) // 2  # the view's middle rows: through the object
    o, d = ro[mid:mid + ITER_RAYS].contiguous(), rd[mid:mid + ITER_RAYS].contiguous()
    near, far = near_far_from_aabb(o, d, aabb, trainer.min_near)
    cases.append(("iterative round 1 (a val view, from the near, no jitter)", (o, d, near, far, skip),
                  dict(kw, slab=ITER_SUB_SLAB), True))
    m = march_rays_skip(o, d, near, far, skip, slab=ITER_SUB_SLAB, **kw)
    last = torch.clamp(m.count - 1, min=0)[:, None]
    t_cur = torch.where(m.count > 0, (m.ts.gather(1, last) + m.dts.gather(1, last))[:, 0], far)
    cases += [("iterative round 2 (from where round 1 stopped)", (o, d, t_cur, far, skip),
               dict(kw, slab=ITER_SUB_SLAB), False),
              (f"iterative round 2 under max_iters {ITER_MAX_ITERS}", (o, d, t_cur, far, skip),
               dict(kw, slab=ITER_SUB_SLAB, max_iters=ITER_MAX_ITERS), False)]
    return cases


def phase_march_kernel(trainer, ds, val_ds, dev) -> dict:
    """``[kernel-march]``: the card's dependent-load latency over a buffer
    the size of the skip field, then the skip-walk kernel against the plain
    walk, bit for bit, on ``march_cases``. Returns the kernels line's entry,
    with the -O slab-128 case's numbers."""
    from focnerf_tpu_torch.utils.measure import dependent_load_ns

    cases = march_cases(trainer, ds, val_ds, dev)
    nbytes = cases[0][1][4].numel()
    load_ns = dependent_load_ns(nbytes, dev)
    print(f"[kernel-march] dependent-load latency: {load_ns:.2f} ns a load (one thread chasing a random cycle "
          f"through {nbytes} B, L2-resident)")
    rows = [march_check(tag, *args, time_it=timed, plain_iters=2 if "iterative" in tag else 3, load_ns=load_ns,
                        **kw) for tag, args, kw, timed in cases]
    row = rows[0]
    return {
        "name": "march_rays_skip",
        "route": "cuda",
        "source": "focnerf_tpu_torch/csrc/march_skip.cu",
        "replaces": "focnerf_tpu/ops/marching.py:160 (an XLA while_loop; no Pallas kernel)",
        "max_abs_err": max(r["err"] for r in rows),
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": "bytes",
        # the walk's own bound: its leaps' dependent reads (see march_check)
        "latency_bound_ms": row["latency_bound_ms"],
        "walk_bound_ms": row["walk_bound_ms"],
        "walk_bound_by": row["walk_bound_by"],
        "load_ns": load_ns,
        "library_ms": None,  # no PyTorch call walks a skip field
    }


FUSED_K, FUSED_O2_K, FUSED_VOXEL_K = 16, 4, 8  # steps per dispatch of the -O, -O2 and dense voxel checks
# the -O CLI runs: 5 epochs of 50 steps (at 150 steps the loss read 0.070
# -> 0.041, short of half)
FUSED_ITERS = 250
FUSED_VOXEL_ITERS = 48  # the captures (one per shear-warp variant) amortized over 6 chunks
FUSED_LOSS_REL, FUSED_TABLE_REL = 1e-4, 1e-3  # first chunk: losses (relative), hash table (relative L2)


def phase_fused(work: str, dev, smi: str, ds) -> dict:
    """``[fused]``: ``--steps_per_dispatch`` on the card. (1) The first chunk:
    trainers with ``main_nerf``'s options for ``-O --steps_per_dispatch
    FUSED_K`` and ``-O2 --steps_per_dispatch FUSED_O2_K`` (grad-level phases
    2) train one chunk on phase 5's split beside the per-step trainer of the
    same seed: the losses within FUSED_LOSS_REL, the hash table after it
    within FUSED_TABLE_REL (the table gradient's atomics sum in any order),
    the steps from CUDA graphs (one capture per phase, the rest replays), the
    backward kernels and the walk once a step. (2) ``main_nerf -O
    --steps_per_dispatch FUSED_K --iters FUSED_ITERS`` beside the same run
    per step: ms/step of each, graph replays, launches (the walk once a step
    and once an eval round), and both losses must halve (first chunk to last).
    (3) The dense voxel engine ``main_voxel`` trains (``fit_voxels``, remat
    on) at VOXEL_RES^3 on phase 5's views, FUSED_VOXEL_ITERS steps with
    ``steps_per_dispatch`` FUSED_VOXEL_K beside per-step: the first chunk's
    mse within FUSED_LOSS_REL. Returns the CLI run's launches."""
    import numpy as np
    import torch

    from focnerf_tpu_torch.apps import main_nerf
    from focnerf_tpu_torch.apps.main_nerf import trainer_options
    from focnerf_tpu_torch.apps.main_voxel import _rgb_on_white
    from focnerf_tpu_torch.config import parse_options
    from focnerf_tpu_torch.render.iterative import render_rays_iterative
    from focnerf_tpu_torch.train.trainer import Trainer
    from focnerf_tpu_torch.train.voxel import fit_voxels

    scene = os.path.join(work, "train_scene")

    def chunk_stats(tr):
        chunks = list(tr._fused_cache.values())
        return (sum(c.steps.captures for c in chunks), sum(c.steps.replays for c in chunks))

    for flags, K in ((["-O"], FUSED_K), (["-O2"], FUSED_O2_K)):
        runs, trainers = {}, {}
        for k in (1, K):
            opt = parse_options([scene, *flags, "--iters", str(FUSED_ITERS), "--steps_per_dispatch", str(k)])
            ws = os.path.join(work, f"fused_first_{flags[0].strip('-')}_{k}")
            tr = Trainer("ngp", opt.nerf_config(), workspace=ws, device=dev, **trainer_options(opt))
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.train(ds, None, max_epochs=1, steps_per_epoch=K)
            torch.cuda.synchronize()
            runs[k] = (np.asarray(tr.step_losses), tr.state.params["grid"].detach().clone(), read_counts(),
                       chunk_stats(tr), (time.perf_counter() - t0) * 1e3 / K)
            trainers[k] = tr
        (l1, g1, n1, _, ms1), (lk, gk, nk, (cap, rep), msk) = runs[1], runs[K]
        loss_rel = float(np.abs(lk - l1).max() / np.abs(l1).max())
        table_rel = float((gk - g1).norm() / g1.norm())
        P = 2 if flags == ["-O2"] else 1
        print(f"[fused] {flags[0]} first chunk of {K} steps (trainers with main_nerf's options, phase 5's split): "
              f"losses rel {loss_rel:.3g} (limit {FUSED_LOSS_REL}), hash table rel L2 {table_rel:.3g} (limit "
              f"{FUSED_TABLE_REL}); {cap} graphs captured, {rep} replays; {msk:.2f} ms/step fused, {ms1:.2f} per "
              f"step (the first steps: captures and warm-up included); launches fused {nk}, per step {n1}")
        for name in ("hashgrid_table_grad", "composite_rays_fused_backward", "march_rays_skip"):
            if not nk[name] == n1[name] == K:
                raise AssertionError(f"[fused] {flags[0]}: {name} launched {nk[name]} (fused) / {n1[name]} times "
                                     f"in {K} steps, want once a step")
        # the encode once a step, in the graphs as per step, and in the occupancy updates between chunks
        if nk["hashgrid_encode_forward"] != n1["hashgrid_encode_forward"]:
            raise AssertionError(f"[fused] {flags[0]}: the encode kernel launched {nk['hashgrid_encode_forward']} "
                                 f"(fused) / {n1['hashgrid_encode_forward']} times")
        check_encodes(f"[fused] {flags[0]} first chunk", nk, K)
        if not (cap == P and rep == K - P):
            raise AssertionError(f"[fused] {flags[0]}: {cap} captures and {rep} replays in {K} steps")
        if not (np.isfinite(lk).all() and loss_rel <= FUSED_LOSS_REL and table_rel <= FUSED_TABLE_REL):
            raise AssertionError(f"[fused] {flags[0]}: the fused chunk disagrees with per-step: losses {lk} vs {l1}")
        if flags == ["-O"]:
            # steady state, the grid update at the tick outside the clock: the
            # per-step trainer's steps K + 2 .. 2K (its step K + 1 updates the
            # grid), against the fused trainer's next chunk after its update
            one, fused = trainers[1], trainers[K]
            one._train_step(ds)
            fused._maybe_update_occupancy()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(K - 1):
                one._train_step(ds)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fused._run_fused_chunk(ds, K)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            print(f"[fused] -O steady state at full width, no grid update inside: per step "
                  f"{(t1 - t0) * 1e3 / (K - 1):.2f} ms/step, fused {(t2 - t1) * 1e3 / K:.2f} ms/step (a chunk of {K}: "
                  f"its draws, their staging and {K} graph replays) ({smi})")
        del runs, trainers, g1, gk

    out = {}
    for k in (1, FUSED_K):
        ws = os.path.join(work, f"fused_cli_{k}")
        argv = [scene, "-O", "--workspace", ws, "--disable_yolo", "--iters", str(FUSED_ITERS), "--mesh_res", "0",
                "--ckpt_interval", "10", "--steps_per_dispatch", str(k)]
        reset_counts()
        render_rays_iterative.rounds = 0
        grid_s, real_update = [0.0, 0], Trainer._maybe_update_occupancy

        def timed_update(self):  # the occupancy updates' share of the training time
            if self.occupancy is None or self.global_step % self.update_extra_interval:
                return real_update(self)
            torch.cuda.synchronize()
            t = time.perf_counter()
            real_update(self)
            torch.cuda.synchronize()
            grid_s[0] += time.perf_counter() - t
            grid_s[1] += 1

        Trainer._maybe_update_occupancy = timed_update
        torch.cuda.synchronize()
        t0 = time.time()
        try:
            (tr,) = main_nerf.main(argv, device=dev)
        finally:
            Trainer._maybe_update_occupancy = real_update
        torch.cuda.synchronize()
        wall = time.time() - t0
        with open(os.path.join(ws, "train_times.txt")) as f:
            train_s = float(f.read().split(":")[1].split("s")[0])
        losses = np.asarray(tr.step_losses)
        steps = len(losses)
        out[k] = dict(losses=losses, launches=read_counts(), rounds=render_rays_iterative.rounds, graphs=chunk_stats(tr),
                      ms=train_s / steps * 1e3, wall=wall, psnr=tr.last_eval_results["PSNR"],
                      steps_ms=(train_s - grid_s[0]) / steps * 1e3)
        first, last = float(losses[:FUSED_K].mean()), float(losses[-FUSED_K:].mean())
        o = out[k]
        print(f"[fused] main_nerf -O --steps_per_dispatch {k} --iters {FUSED_ITERS}: {steps} steps, "
              f"{o['ms']:.2f} ms/step ({train_s:.2f} s of training, of which {grid_s[1]} occupancy updates "
              f"{grid_s[0]:.2f} s: {o['steps_ms']:.2f} ms/step without them; {wall:.2f} s with loading and the eval), "
              f"{o['graphs'][0]} graphs captured, {o['graphs'][1]} replays; loss first {FUSED_K} steps {first:.5f}, "
              f"last {FUSED_K} {last:.5f}; val PSNR {o['psnr']:.3f} dB; launches {o['launches']} "
              f"({o['rounds']} eval rounds) ({smi})")
        n = o["launches"]
        if n["hashgrid_table_grad"] != steps or n["composite_rays_fused_backward"] != steps \
                or n["march_rays_skip"] != steps + o["rounds"]:
            raise AssertionError(f"[fused] --steps_per_dispatch {k}: launches {n} in {steps} steps and "
                                 f"{o['rounds']} eval rounds")
        check_encodes(f"[fused] --steps_per_dispatch {k}", n, steps + o["rounds"])
        if not (np.isfinite(losses).all() and last < 0.5 * first):
            raise AssertionError(f"[fused] --steps_per_dispatch {k}: the loss did not halve ({first} -> {last})")
        if k > 1 and not o["graphs"][1] > 0:
            raise AssertionError(f"[fused] --steps_per_dispatch {k}: no graph replayed")
    rel = float(np.abs(out[FUSED_K]["losses"][:FUSED_K] - out[1]["losses"][:FUSED_K]).max()
                / np.abs(out[1]["losses"][:FUSED_K]).max())
    print(f"[fused] main_nerf -O: fused {out[FUSED_K]['ms']:.2f} ms/step against {out[1]['ms']:.2f} per step "
          f"({out[1]['ms'] / out[FUSED_K]['ms']:.2f}x; without the occupancy updates {out[FUSED_K]['steps_ms']:.2f} "
          f"against {out[1]['steps_ms']:.2f}); first chunk's losses rel {rel:.3g} (limit {FUSED_LOSS_REL})")
    if not rel <= FUSED_LOSS_REL:
        raise AssertionError(f"[fused] main_nerf -O: the first chunk's losses differ by {rel} (relative)")

    from focnerf_tpu_torch.data.provider import DatasetOptions, NeRFDataset

    vds = NeRFDataset(DatasetOptions(path=scene, scale=parse_options(["x"]).scale), split="train", device=dev)
    imgs = _rgb_on_white(vds)
    vox = {}
    for k in (1, FUSED_VOXEL_K):
        torch.cuda.synchronize()
        _, info = fit_voxels(vds.poses, imgs, vds.intrinsics, resolution=VOXEL_RES, iters=FUSED_VOXEL_ITERS,
                             steps_per_dispatch=k, device=dev)
        vox[k] = info
    m1, mk = vox[1]["step_mse"], vox[FUSED_VOXEL_K]["step_mse"]
    vrel = float(np.abs(mk[:FUSED_VOXEL_K] - m1[:FUSED_VOXEL_K]).max() / np.abs(m1[:FUSED_VOXEL_K]).max())
    print(f"[fused] dense voxel {VOXEL_RES}^3 (main_voxel's fit_voxels, remat on), {FUSED_VOXEL_ITERS} steps: "
          f"steps_per_dispatch {FUSED_VOXEL_K} {vox[FUSED_VOXEL_K]['seconds'] / FUSED_VOXEL_ITERS * 1e3:.2f} ms/step "
          f"against {vox[1]['seconds'] / FUSED_VOXEL_ITERS * 1e3:.2f} per step (captures and the GT pre-warps "
          f"included); first chunk's mse rel {vrel:.3g} (limit {FUSED_LOSS_REL}), last mse {mk[-1]:.5f} vs "
          f"{m1[-1]:.5f} ({smi})")
    if not (np.isfinite(mk).all() and vrel <= FUSED_LOSS_REL):
        raise AssertionError(f"[fused] dense voxel: the fused chunk's mse {mk} vs per-step {m1}")
    del vds, imgs
    return out[FUSED_K]["launches"]


def phase_reference(params, cfg, bits):
    """One 96x96 view on the card (kernel) and on the CPU (plain versions),
    through the occupancy path with the main path's bitfield ``bits`` and
    through the uniform path (``main_nerf --test`` without ``-O``); on the
    card each path must composite its one chunk through the kernel."""
    import dataclasses

    import numpy as np
    import torch

    from focnerf_tpu_torch.core.camera import rand_poses
    from focnerf_tpu_torch.ops.composite import composite_rays_fused
    from focnerf_tpu_torch.ops.hashgrid import hashgrid_encode_forward
    from focnerf_tpu_torch.render.renderer import render_image

    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)  # no bf16 flips
    pose = rand_poses(np.random.default_rng(3), 1, radius=4.0)[0]
    intr = np.array([115.2, 115.2, 48, 48], np.float32)
    feat = np.random.default_rng(4).normal(size=144).astype(np.float32)
    cpu_params = {k: (v.cpu() if torch.is_tensor(v) else [w.cpu() for w in v]) for k, v in params.items()}
    common = dict(obj_feat=feat, bg_color=1.0, max_ray_batch=96 * 96)
    paths = {
        "occupancy": (dict(occ_bits=bits, dt_gamma=1 / 128, max_steps=1024, slab=128),
                      dict(occ_bits=bits.cpu(), dt_gamma=1 / 128, max_steps=1024, slab=128)),
        "uniform": (dict(num_steps=128), dict(num_steps=128)),
    }
    for path, (gpu_kw, cpu_kw) in paths.items():
        reset_counts()
        gpu, _ = render_image(params, cfg32, pose, intr, 96, 96, **common, **gpu_kw)
        if composite_rays_fused.launches != 1 or hashgrid_encode_forward.launches != 1:
            raise AssertionError(f"reference {path}: {read_counts()}, want one composite and one encode launch")
        cpu, _ = render_image(cpu_params, cfg32, pose, intr, 96, 96, **common, **cpu_kw)
        if not torch.isfinite(gpu).all():
            raise AssertionError(f"reference {path}: non-finite render on the card")
        diff = (gpu.cpu() - cpu).abs()
        far = float((diff > 1e-3).float().mean())
        print(f"[reference] {path} path, 96x96 fp32 view, card vs CPU: max_abs_err {float(diff.max()):.3g}, "
              f"mean {float(diff.mean()):.3g}, share > 1e-3: {far:.4f} (limits: mean 1e-4, share 0.01)")
        # sums in other orders and libm vs CUDA exp/pow; on the occupancy
        # path a candidate on a cell boundary may flip cells, which moves
        # that ray's samples
        if not (float(diff.mean()) <= 1e-4 and far <= 0.01):
            raise AssertionError(f"reference {path}: card and CPU renders disagree")


def train_dataset(scene: str, dev, split: str = "train"):
    """A split of the training scene, loaded as ``main_nerf -O`` loads it."""
    from focnerf_tpu_torch.apps.main_nerf import mask_details_for
    from focnerf_tpu_torch.config import parse_options
    from focnerf_tpu_torch.data.provider import NeRFDataset
    from focnerf_tpu_torch.data.yolo_sidecar import load_sidecar

    opt = parse_options([scene, "-O"])
    return NeRFDataset(opt.dataset_options(), split=split, device=dev,
                       mask_details=mask_details_for(load_sidecar(scene, split), OBJECT))


def phase_train_profile(trainer, ds, dev, steps: int = 3):
    """Where a training step's time goes, on the trained model: each stage
    of ``steps`` steps timed with a synchronize around it, then the same
    steps under torch.profiler for the device's busy share and top kernels."""
    import torch

    from focnerf_tpu_torch.core.geometry import near_far_from_aabb
    from focnerf_tpu_torch.ops.marching import march_rays_skip
    from focnerf_tpu_torch.render.renderer import default_aabb
    from focnerf_tpu_torch.train.steps import occupancy_loss, step_draws

    state, cfg, slab = trainer.state, trainer.cfg, trainer.active_slab
    occ = trainer._occ_bits_for_batch()
    kw = dict(dt_gamma=trainer.dt_gamma, max_steps=trainer.max_steps, slab=slab, skip_field=True)
    stages = {"batch + draws": 0.0, "march (skip walk)": 0.0, "forward (march + field + composite + loss)": 0.0,
              "backward": 0.0, "optimizer + EMA": 0.0}

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    def staged_step(record: bool):
        t0 = clock()
        batch = ds.train_batch(trainer.generator)
        draws = step_draws(trainer.generator, cfg, batch["rays_o"].shape[0], slab, dev)
        t1 = clock()
        near, far = near_far_from_aabb(batch["rays_o"], batch["rays_d"], default_aabb(cfg, dev), trainer.min_near)
        march_rays_skip(batch["rays_o"], batch["rays_d"], near, far, occ, bound=cfg.bound,
                        dt_gamma=trainer.dt_gamma, max_steps=trainer.max_steps, slab=slab, noise=draws["noise"])
        t2 = clock()
        loss, _ = occupancy_loss(state.params, cfg, batch, occ, draws, **kw)
        t3 = clock()
        loss.backward()
        t4 = clock()
        state.apply_gradients()
        t5 = clock()
        if record:
            for k, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4)):
                stages[k] += dt * 1e3 / steps

    for _ in range(2):  # warm-up
        staged_step(False)
    with SMClocks() as staged_clocks:
        for _ in range(steps):
            staged_step(True)
    total = sum(v for k, v in stages.items() if not k.startswith("march"))
    print("[profile] training step at slab " + str(slab) + ", stage-timed (synchronized), ms/step: "
          + ", ".join(f"{k} {v:.2f} ({v / total:.1%})" for k, v in stages.items())
          + f"; step total {total:.2f} (the march runs again inside the forward); {staged_clocks.summary()}")

    profiled_steps(trainer, ds, steps, "profile")


def profiled_steps(trainer, ds, steps: int, tag: str):
    """``steps`` of ``trainer.train_step_once`` under torch.profiler: wall
    and device-busy ms/step, the busy share, the top device kernels and the
    port's three kernels' share, on lines tagged ``tag``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from focnerf_tpu_torch.utils.measure import busy_ms, device_events

    trainer.train_step_once(ds)  # warm-up
    torch.cuda.synchronize()
    with SMClocks() as clocks, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step_once(ds)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    busy = busy_ms(prof)
    by_name = {}
    for name, ms in events:
        by_name[name] = by_name.get(name, 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"[{tag}] {steps} train steps under torch.profiler: wall {wall / steps:.2f} ms/step, device busy "
          f"{busy / steps:.2f} ms/step ({busy / wall:.1%}; idle {1 - busy / wall:.1%}), "
          f"{len(events) / steps:.0f} device events/step; {clocks.summary()}")
    for name, ms in top:
        print(f"[{tag}]   {ms / steps:8.3f} ms/step {ms / busy:6.1%}  {name[:110]}")
    for key in ("composite_forward_kernel", "composite_backward_kernel", "table_grad_kernel"):
        ms = sum(v for k, v in by_name.items() if key in k)
        print(f"[{tag}]   kernel {key}: {ms / steps:.4f} ms/step ({ms / busy:.2%} of device time)")


def prefix_in(s, G: int):
    """The optical depth entering each sample of ``s`` [n, t], in two
    summation orders: the forward kernel's (one sample after another) and a
    tree order (an inclusive Hillis-Steele scan over each chunk of G samples,
    shifted by one, plus the carry of the chunks before)."""
    import torch

    n, t = s.shape
    seq, tree = torch.empty_like(s), torch.empty_like(s)
    acc = torch.zeros(n, device=s.device)
    for i in range(t):
        seq[:, i] = acc
        acc = acc + s[:, i]
    carry = torch.zeros(n, device=s.device)
    for c0 in range(0, t, G):
        x = torch.zeros(n, G, device=s.device)
        x[:, :min(G, t - c0)] = s[:, c0:c0 + G]
        d = 1
        while d < G:
            x = torch.cat([x[:, :d], x[:, d:] + x[:, :-d]], 1)
            d *= 2
        excl = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], 1)
        tree[:, c0:c0 + G] = (carry[:, None] + excl)[:, :min(G, t - c0)]
        carry = carry + x[:, -1]
    return seq, tree


def phase_backward_mask(trainer, ds, dev):
    """On real chunks, one train step of the trained model at each of the
    slabs 128, 32 and 16, as the composite backward receives them: the
    backward kernel must mask (T_in < T_thresh) exactly the samples the
    forward's loop masks, whose optical depth is a sum in sample order.
    Beside it, how many samples a tree-ordered prefix would mask otherwise.
    The mask shows in drgb = w * gI with gI = 1, where 1 - exp(-s) > 0."""
    import torch

    from focnerf_tpu_torch.ops import composite as tcomp
    from focnerf_tpu_torch.train.steps import occupancy_loss, step_draws

    chunks, kernel = [], tcomp.composite_rays_fused_backward

    def capture(sigmas, rgbs, deltas, ts, bg_color, outputs, grads, *args):
        chunks.append((sigmas.detach(), rgbs.detach(), deltas, ts, bg_color, *args))
        return kernel(sigmas, rgbs, deltas, ts, bg_color, outputs, grads, *args)

    capture.launches = 0  # the wrapper counts on whatever the module's name holds

    state, cfg, occ = trainer.state, trainer.cfg, trainer._occ_bits_for_batch()
    tcomp.composite_rays_fused_backward = capture
    try:
        for slab in (128, 32, 16):
            batch = ds.train_batch(trainer.generator)
            draws = step_draws(trainer.generator, cfg, batch["rays_o"].shape[0], slab, dev)
            loss, _ = occupancy_loss(state.params, cfg, batch, occ, draws, dt_gamma=trainer.dt_gamma,
                                     max_steps=trainer.max_steps, slab=slab, skip_field=True)
            loss.backward()
    finally:
        tcomp.composite_rays_fused_backward = kernel
    state.zero_grad()

    bad = []
    for sig, rgb, dts, ts, bg, density_scale, thresh in chunks:
        n, t = sig.shape
        with torch.no_grad():
            outs = tcomp.composite_rays_fused(sig, rgb, dts, ts, bg, density_scale, thresh)
        ones = torch.ones((n, 3), device=sig.device)
        _, d_rgb = kernel(sig, rgb, dts, ts, bg, outs, (ones, None, None), density_scale, thresh)
        s = dts * density_scale * sig
        seq, tree = prefix_in(s, tcomp.group_width(t))
        shown = s > 1e-6  # 1 - exp(-s) > 0 on every exp
        want = torch.exp(-seq) >= thresh
        got_bad = int(((d_rgb[..., 0] != 0) != want)[shown].sum())
        tree_bad = int(((torch.exp(-tree) >= thresh) != want)[shown].sum())
        print(f"[mask] composite backward on a real [{n},{t}] chunk, T_thresh {thresh:g}: "
              f"{int(want[shown].sum())} live of {int(shown.sum())} samples with s > 1e-6; kernel's mask "
              f"differs from the forward's on {got_bad}; a tree-ordered prefix would differ on {tree_bad} "
              f"(its T_in exponent differs on {int((seq != tree)[shown].sum())} samples)")
        if got_bad:
            bad.append((t, got_bad))
    if len(chunks) != 3 or bad:
        raise AssertionError(f"composite backward mask: {len(chunks)} chunks, mismatches {bad}")


def phase_eval_renderers(trainer, ds):
    """The trained model's val views through each eval renderer (the EMA
    params, as ``evaluate``): s/view, rounds per view, composite_rays_resume
    launches and val PSNR of each, ``iter`` on the first EVAL_VIEWS["iter"], ``iter_dev`` on
    the first EVAL_VIEWS["iter_dev"] and ``oneshot`` on the centre
    ONESHOT_CROP^2 of the first EVAL_VIEWS["oneshot"] (~25-36 s a whole
    view). ``iter`` and ``iter_dev`` run the same per-ray rounds (only the
    batch shapes of the bf16 MLP products differ): they must agree within
    1e-4 mean absolute per view, and on the pixels ``oneshot`` renders
    neither may fall more than 0.5 dB below it."""
    import numpy as np
    import torch

    from focnerf_tpu_torch.render.iterative import render_rays_iterative
    from focnerf_tpu_torch.train.meters import LPIPSMeter, psnr

    from types import SimpleNamespace

    params, kept = trainer.state.ema_params, trainer.eval_renderer
    images, rows = {}, {}
    c, y0, x0 = ONESHOT_CROP, (ds.H - ONESHOT_CROP) // 2, (ds.W - ONESHOT_CROP) // 2
    fx, fy, cx, cy = (float(v) for v in np.asarray(ds.intrinsics).reshape(-1))
    crop = SimpleNamespace(intrinsics=np.asarray([fx, fy, cx - x0, cy - y0], np.float32), H=c, W=c)
    for renderer in ("iter", "iter_dev", "oneshot"):
        trainer.eval_renderer = renderer
        kw = trainer._render_kwargs()
        reset_counts()
        render_rays_iterative.rounds = 0
        images[renderer], seconds, psnrs = [], [], []
        n_views = min(ds.n_views, EVAL_VIEWS.get(renderer, ds.n_views))
        for v in range(n_views):
            view = ds.eval_view(v)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img, _ = trainer._render_view(params, view, crop if renderer == "oneshot" else ds, kw)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            gt = view["pixels"].reshape(ds.H, ds.W, -1)
            if gt.shape[-1] == 4:  # as evaluate: RGBA on white
                gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:])
            if renderer == "oneshot":
                gt = gt[y0:y0 + c, x0:x0 + c]
            psnrs.append(float(psnr(torch.clamp(img, 0.0, 1.0), gt)))
            images[renderer].append(img)
        launches, rounds = read_counts(), render_rays_iterative.rounds
        rows[renderer] = psnrs
        size = f"{c}x{c} (the centre of {ds.W}x{ds.H})" if renderer == "oneshot" else f"{ds.W}x{ds.H}"
        print(f"[eval] {renderer}: {n_views} val views of {size}, s/view {np.mean(seconds):.3f} "
              f"(views {', '.join(f'{x:.3f}' for x in seconds)}), rounds/view {rounds / n_views:.1f}, "
              f"composite_rays_resume launches {launches['composite_rays_resume']}, val PSNR "
              f"{np.mean(psnrs):.3f} dB (views {', '.join(f'{x:.3f}' for x in psnrs)})")
        if renderer != "oneshot" and launches["composite_rays_resume"] != rounds:
            raise AssertionError(f"{renderer}: {rounds} rounds, launches {launches}")
    trainer.eval_renderer = kept
    gt = ds.eval_view(0)["pixels"].reshape(ds.H, ds.W, -1)
    gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:]) if gt.shape[-1] == 4 else gt
    meter, pred = LPIPSMeter(), torch.clamp(images["iter"][0], 0.0, 1.0)
    meter.update(pred, gt)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    meter.update(pred, gt)
    torch.cuda.synchronize()
    print(f"[eval] the evaluate meter {meter.name} on one {ds.W}x{ds.H} view: {time.perf_counter() - t0:.4f} s "
          f"after a warm-up (value {meter.measure():.4f}), paid per view by every evaluate()")
    diffs = [float((a - b).abs().mean()) for a, b in zip(images["iter"], images["iter_dev"])]
    print(f"[eval] iter vs iter_dev mean absolute difference per view: "
          f"{', '.join(f'{x:.3g}' for x in diffs)} (limit 1e-4)")
    if not max(diffs) <= 1e-4:
        raise AssertionError(f"iter and iter_dev renders differ: {diffs}")
    shared = len(rows["oneshot"])
    for renderer in ("iter", "iter_dev"):
        on_crop = []
        for v in range(shared):
            gt = ds.eval_view(v)["pixels"].reshape(ds.H, ds.W, -1)[y0:y0 + c, x0:x0 + c]
            gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:]) if gt.shape[-1] == 4 else gt
            on_crop.append(float(psnr(torch.clamp(images[renderer][v][y0:y0 + c, x0:x0 + c], 0.0, 1.0), gt)))
        print(f"[eval] {renderer} on oneshot's {c}x{c} pixels: PSNR {', '.join(f'{x:.3f}' for x in on_crop)} dB "
              f"(oneshot {', '.join(f'{x:.3f}' for x in rows['oneshot'])})")
        if not np.mean(on_crop) >= np.mean(rows["oneshot"]) - 0.5:
            raise AssertionError(f"{renderer} val PSNR {on_crop} more than 0.5 dB below oneshot's "
                                 f"{rows['oneshot']} on the same pixels")


def phase_iterative_reference(trainer):
    """One 96x96 view of the trained model through render_image_iterative
    on the card (kernel) and on the CPU (plain versions), with the same
    skip field, in fp32; on the card composite_rays_resume must run once a
    round."""
    import dataclasses

    import numpy as np
    import torch

    from focnerf_tpu_torch.core.camera import rand_poses
    from focnerf_tpu_torch.ops.composite import composite_rays_resume
    from focnerf_tpu_torch.ops.occupancy import occupancy_bitfield, occupancy_skip_field
    from focnerf_tpu_torch.render.iterative import render_image_iterative, render_rays_iterative

    cfg32 = dataclasses.replace(trainer.cfg, compute_dtype=torch.float32)  # no bf16 flips
    pose = rand_poses(np.random.default_rng(3), 1, radius=CAMERA_RADIUS)[0]
    intr = np.array([115.2, 115.2, 48, 48], np.float32)
    skip = occupancy_skip_field(occupancy_bitfield(trainer.occupancy, trainer.density_thresh))
    params = trainer.state.ema_params
    cpu_params = {k: (v.cpu() if torch.is_tensor(v) else [w.cpu() for w in v]) for k, v in params.items()}
    kw = dict(dt_gamma=trainer.dt_gamma, max_steps=trainer.max_steps, min_near=trainer.min_near, bg_color=1.0,
              obj_feat=np.zeros(144, np.float32))  # the training scene's object feature
    composite_rays_resume.launches = render_rays_iterative.rounds = 0
    gpu, _ = render_image_iterative(params, cfg32, pose, intr, 96, 96, occ_skip=skip, **kw)
    rounds = render_rays_iterative.rounds
    if not composite_rays_resume.launches == rounds > 0:
        raise AssertionError(f"iterative reference: {composite_rays_resume.launches} launches in {rounds} rounds")
    cpu, _ = render_image_iterative(cpu_params, cfg32, pose, intr, 96, 96, occ_skip=skip.cpu(), **kw)
    if not torch.isfinite(gpu).all():
        raise AssertionError("iterative reference: non-finite render on the card")
    diff = (gpu.cpu() - cpu).abs()
    far = float((diff > 1e-3).float().mean())
    print(f"[reference] iterative renderer, 96x96 fp32 view of the trained model, {rounds} rounds, card vs CPU: "
          f"max_abs_err {float(diff.max()):.3g}, mean {float(diff.mean()):.3g}, share > 1e-3: {far:.4f} "
          f"(limits, as the occupancy path's: mean 1e-4, share 0.01); object share "
          f"{float((cpu < 0.99).any(-1).float().mean()):.3f}")
    # as the occupancy path: sums in other orders and libm vs CUDA exp/pow;
    # a walk landing on a cell boundary may flip cells and move a ray's samples
    if not (float(diff.mean()) <= 1e-4 and far <= 0.01):
        raise AssertionError("iterative reference: card and CPU renders disagree")


def phase_train_reference(trainer, ds):
    """Train steps' loss and gradients on the card (kernels) and on the CPU
    (plain versions), from the trained params and skip field, the same batch
    and the same draws, in fp32: the -O step; the uniform step with
    importance upsampling (no -O); an -O2 step in a truncated c2f stage on a
    gradient phase; the -O step on a patch-sampled batch of the training
    scene; and the -O step with the TV term. Each launches each kernel once
    on the card."""
    import dataclasses

    import numpy as np
    import torch

    from focnerf_tpu_torch.core.camera import rand_poses
    from focnerf_tpu_torch.ops.occupancy import occupancy_bitfield, occupancy_skip_field
    from focnerf_tpu_torch.train.state import clone_params, param_leaves
    from focnerf_tpu_torch.train.steps import occupancy_loss, step_draws, uniform_loss, uniform_step_draws

    cfg32 = dataclasses.replace(trainer.cfg, compute_dtype=torch.float32)
    n, slab = 512, 64
    rng = np.random.default_rng(9)
    pose = rand_poses(rng, 1, radius=4.0)[0]
    d = rng.normal(size=(n, 3)).astype(np.float32) * 0.15 + pose[:3, 2]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    batch = {
        "rays_o": torch.from_numpy(np.broadcast_to(pose[:3, 3], d.shape).astype(np.float32).copy()),
        "rays_d": torch.from_numpy(d.astype(np.float32)),
        "pixels": torch.from_numpy(rng.uniform(0, 1, (n, 4)).astype(np.float32)),
        "ray_mask": torch.from_numpy(rng.uniform(size=n) < 0.7),
        "obj_feat": torch.from_numpy(rng.normal(size=144).astype(np.float32)),
    }
    ds.opt.patch_size = 8  # 16 patches of 8 x 8 of one view
    patch = {k: v.cpu() for k, v in ds.train_batch(trainer.generator).items() if k != "view"}
    ds.opt.patch_size = 1
    patch = {k: v[:1024] if v.dim() and v.shape[0] == 4096 else v for k, v in patch.items()}
    skip = occupancy_skip_field(occupancy_bitfield(trainer.occupancy, trainer.density_thresh)).cpu()
    occ_kw = dict(dt_gamma=trainer.dt_gamma, max_steps=trainer.max_steps, slab=slab, skip_field=True)
    uni = dataclasses.replace(cfg32, stochastic_corners=0, stochastic_min_size=0)  # no -O: the exact encode
    o2 = dataclasses.replace(cfg32, active_levels=8, grad_levels=(1, 3, 5, 7))  # stage 8, phase 1 of 2
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    cases = {
        "-O step": (cfg32, batch, step_draws(gen(), cfg32, n, slab, "cpu"), occ_kw),
        "uniform step, 64 + 32 importance samples": (
            uni, batch, uniform_step_draws(gen(), uni, n, 64, 32, "cpu"), dict(num_steps=64, upsample_steps=32)),
        "-O2 step, c2f stage of 8 levels, phase 1 (levels 1, 3, 5, 7)": (
            o2, batch, step_draws(gen(), o2, n, slab, "cpu"), occ_kw),
        "-O step on a patch-sampled batch (16 patches of 8 x 8)": (
            cfg32, patch, step_draws(gen(), cfg32, 1024, slab, "cpu"), occ_kw),
        "-O step with TV 1e-2": (cfg32, batch, step_draws(gen(), cfg32, n, slab, "cpu", tv=True),
                                 dict(occ_kw, tv_weight=1e-2)),
    }
    for label, (cfg, b, draws, kw) in cases.items():
        out = {}
        for where in ("cuda", "cpu"):
            to = lambda t: t.to(where)  # noqa: E731
            params = clone_params({k: [to(w) for w in v] if isinstance(v, list) else to(v)
                                   for k, v in trainer.state.params.items()}, requires_grad=True)
            tb, td = {k: to(v) for k, v in b.items()}, {k: to(v) for k, v in draws.items()}
            reset_counts()
            if "num_steps" in kw:
                loss, _ = uniform_loss(params, cfg, tb, td, **kw)
            else:
                loss, _ = occupancy_loss(params, cfg, tb, to(skip), td, **kw)
            loss.backward()
            walks = int(kw.get("skip_field", False))  # the skip walk's kernel, once a march
            encodes = 2 if kw.get("upsample_steps") else 1  # the importance samples' coarse pass encodes too
            if where == "cuda" and read_counts() != dict(composite_rays_fused=1, composite_rays_resume=0,
                                                         composite_rays_fused_backward=1, hashgrid_table_grad=1,
                                                         march_rays_skip=walks, hashgrid_encode_forward=encodes,
                                                         hashgrid_input_grad=0):
                raise AssertionError(f"reference {label} on the card launched {read_counts()}")
            out[where] = (float(loss.detach()), [p.grad.cpu() for p in param_leaves(params)])
        (lg, gg), (lc, gc) = out["cuda"], out["cpu"]
        loss_rel = abs(lg - lc) / abs(lc)
        grad_rel = max(float((a - b_).norm() / b_.norm().clamp(min=1e-30)) for a, b_ in zip(gg, gc))
        grid = gc[0].reshape(-1, cfg.level_dim)
        print(f"[reference] train step: {label}, {b['rays_o'].shape[0]} rays, fp32, card vs CPU: loss {lg:.6g} vs "
              f"{lc:.6g} (rel {loss_rel:.3g}, limit 1e-4), worst gradient rel L2 error {grad_rel:.3g} (limit 1e-2); "
              f"table rows with a gradient: {int((grid != 0).any(-1).sum())}")
        # sums in other orders, atomics and CUDA vs libm exp/log; a walk landing
        # on a cell boundary may flip cells on one side and move that ray's samples
        if not (loss_rel <= 1e-4 and grad_rel <= 1e-2):
            raise AssertionError(f"card and CPU train steps disagree: {label}")
        if cfg is o2:  # the table rows outside the phase's levels get exactly 0, on the card too
            spec = cfg.grid_spec
            for lvl in range(spec.num_levels):
                blk = gg[0][spec.offsets[lvl]:spec.offsets[lvl + 1]]
                if (lvl in cfg.grad_levels) != bool((blk != 0).any()):
                    raise AssertionError(f"-O2 reference: level {lvl}'s table gradient, live {lvl in cfg.grad_levels}")


def uniform_scene(work: str) -> str:
    """Phase 5's training scene with its val split cut to one view: the
    train split, its sidecar and the val images linked, a val JSON of the
    first val frame."""
    src, scene = os.path.join(work, "train_scene"), os.path.join(work, "uniform_scene")
    os.makedirs(os.path.join(scene, "yolo"))
    for rel in ("train", "val", "transforms_train.json", "yolo/train.npz", "yolo/val.npz"):
        os.symlink(os.path.join(src, rel), os.path.join(scene, rel))
    with open(os.path.join(src, "transforms_val.json")) as f:
        val = json.load(f)
    val["frames"] = val["frames"][:1]
    with open(os.path.join(scene, "transforms_val.json"), "w") as f:
        json.dump(val, f)
    return scene


def phase_uniform_train(work: str, dev, smi: str):
    """``main_nerf`` without ``-O`` at full width on phase 5's scene (one
    val view): uniform samples with importance upsampling, the error map and
    the TV term, UNIFORM_ITERS steps, then its eval and its mesh. Each
    backward kernel launches once a step and the composite forward once a
    step plus once per chunk of the eval view; the loss must halve, the val
    PSNR be finite, the error map leave its 0.1 fill on exactly the views
    the batches drew and the OBJ have faces. Returns the launches."""
    import numpy as np
    import torch

    from focnerf_tpu_torch.apps import main_nerf
    from focnerf_tpu_torch.data import provider
    from focnerf_tpu_torch.models.nerf import density_fn

    scene, ws = uniform_scene(work), os.path.join(work, "uniform_ws")
    argv = [scene, "--workspace", ws, "--disable_yolo", "--iters", str(UNIFORM_ITERS), "--num_steps",
            str(UNIFORM_STEPS[0]), "--upsample_steps", str(UNIFORM_STEPS[1]), "--error_map", "--tv_weight",
            str(UNIFORM_TV), "--ckpt_interval", "10"]
    datasets, real = [], provider.NeRFDataset

    class Kept(real):  # the train split, whose error map the trainer updates, and its batches' views
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.views = []
            datasets.append(self)

        def train_batch(self, generator, draws=None):
            batch = super().train_batch(generator, draws)
            self.views.append(batch["view"])
            return batch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    provider.NeRFDataset = Kept
    t0 = time.time()
    try:
        with SMClocks() as clocks, EncodeCalls() as encodes:
            (trainer,) = main_nerf.main(argv, device=dev)
            torch.cuda.synchronize()
    finally:
        provider.NeRFDataset = real
    wall = time.time() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    with open(os.path.join(ws, "train_times.txt")) as f:
        train_s = float(f.read().split(":")[1].split("s")[0])
    losses = np.asarray(trainer.step_losses)
    steps = len(losses)
    first, last = float(losses[:20].mean()), float(losses[-20:].mean())
    psnr = trainer.last_eval_results["PSNR"]
    em = datasets[0].error_map
    moved = (em != 0.1).any(-1).cpu()
    trained = torch.zeros_like(moved)
    trained[torch.stack(datasets[0].views).cpu()] = True
    from focnerf_tpu_torch.utils.mesh_extract import extract_fields

    params, cfg = trainer.state.ema_params, trainer.cfg
    sigma_max = float(extract_fields(lambda x: density_fn(params, cfg, x)[0], cfg.bound, 64, dev).max())
    mesh = os.path.join(f"{ws}_{OBJECT}", "meshes", f"ngp_{trainer.epoch}.obj")
    faces = _faces(mesh) if os.path.exists(mesh) else 0
    samples = sum(UNIFORM_STEPS)
    eval_chunks = math.ceil(RES * RES / CHUNK)
    print(f"[uniform] main_nerf (no -O) --num_steps {UNIFORM_STEPS[0]} --upsample_steps {UNIFORM_STEPS[1]} "
          f"--error_map --tv_weight {UNIFORM_TV} --iters {UNIFORM_ITERS}: {steps} steps of 4096 rays x {samples} "
          f"samples ({4096 * samples} samples/step) in {train_s:.2f} s of training ({wall:.2f} s with loading, "
          f"the eval and the mesh): {train_s / steps * 1e3:.2f} ms/step, {4096 * steps / train_s:.0f} rays/s, peak "
          f"memory {peak:.3f} GiB ({smi}); {clocks.summary()}")
    print(f"[uniform] loss first 20 steps {first:.5f}, last 20 {last:.5f}; val PSNR {psnr:.3f} dB (1 view); error "
          f"map moved on {int(moved.sum())} of {em.shape[0]} views, {int(trained.sum())} of them trained (mean "
          f"{float(em.mean()):.4f}); mesh {faces} faces at density {trainer.density_thresh} (max density on a 64^3 "
          f"grid {sigma_max:.2f}); launches {launches}")
    # the encode: twice a step and an eval chunk (the importance samples' coarse
    # pass, then every sample), and once a slab of the mesh's density grid
    want = dict(composite_rays_fused=steps + eval_chunks, composite_rays_resume=0,
                composite_rays_fused_backward=steps, hashgrid_table_grad=steps, march_rays_skip=0,
                hashgrid_encode_forward=len(encodes.points), hashgrid_input_grad=0)
    if launches != want or len(encodes.points) < 2 * (steps + eval_chunks):
        raise AssertionError(f"uniform training launched {launches}, want {want}")
    if steps != UNIFORM_ITERS or not np.isfinite(losses).all() or not last < 0.5 * first:
        raise AssertionError(f"uniform training did not learn: {steps} steps, loss {first} -> {last}")
    if not np.isfinite(psnr) or not torch.equal(moved, trained) or faces == 0:
        raise AssertionError(f"uniform training: val PSNR {psnr}, error map moved on views {moved.nonzero()} "
                             f"(trained {trained.nonzero()}), {faces} faces")
    profiled_steps(trainer, datasets[0], 5, "uniform-profile")
    return launches


def phase_second_object(work: str, dev):
    """The composition's second object: ``main_nerf -O2`` at full width on a
    scene with the training scene's cameras that holds only BALL, whose
    sidecar gives every view the constant feature 0.5 in all 144 entries:
    its c2f stages (8 levels, then 12, then 16) end at SECOND_C2F's steps,
    epoch boundaries, so the epoch times give each stage's ms/step; with
    ``--grad_level_phases 2`` each step's table gradient covers half the
    stage's levels. The table-gradient kernel must launch once a step, on
    the columns of that step's level subset. Its eval renders one val view
    with the iterative renderer (``composite_rays_resume`` once a round)
    over the -O2 field. Returns (workspace, launches)."""
    import torch

    from focnerf_tpu_torch.apps import main_nerf
    from focnerf_tpu_torch.config import parse_options
    from focnerf_tpu_torch.ops import hashgrid as thg

    scene, ws = os.path.join(work, f"{SECOND}_scene"), os.path.join(work, f"{SECOND}_ws")
    c2f = ",".join(f"{end}:{lv}" for end, lv in SECOND_C2F)
    argv = [scene, "-O2", "--c2f", c2f, "--workspace", ws, "--disable_yolo", "--iters", str(SECOND_ITERS),
            "--mesh_res", "0", "--ckpt_interval", "10"]
    # one val view (cut from four for the time limit), no test split
    write_training_scene(scene, parse_options(argv).scale, obj=SECOND, spheres=(BALL,), feat=0.5,
                         splits=("train", "val"), val_views=1)
    columns, kernel = [], thg.hashgrid_table_grad

    def capture(rows, weights, g, cols, n_rows, level_dim=None):
        columns.append(rows.shape[1])
        return kernel(rows, weights, g, cols, n_rows, level_dim=level_dim)

    capture.launches = 0  # the wrapper counts on whatever the module's name holds
    reset_counts()
    thg.hashgrid_table_grad = capture
    t0 = time.time()
    try:
        (trainer,) = main_nerf.main(argv, device=dev)
        torch.cuda.synchronize()
    finally:
        thg.hashgrid_table_grad = kernel
    kernel.launches += capture.launches
    launches = read_counts()
    with open(os.path.join(f"{ws}_{SECOND}", "log_ngp.txt")) as f:
        epochs = [float(line.split("time=")[1].rstrip("s\n")) for line in f if line.startswith("[epoch ")]
    per_epoch = SECOND_ITERS // len(epochs)
    stages, start = [], 0
    for end, lv in list(SECOND_C2F) + [(SECOND_ITERS, 16)]:
        spans = epochs[start // per_epoch:end // per_epoch]
        stages.append(f"{lv} levels (steps {start}-{end - 1}): {sum(spans) / (end - start) * 1e3:.2f} ms/step")
        start = end
    # K = 1 corners: a level subset of n levels has n columns
    want_j = [len([lv for lv in range(active) if lv % 2 == step % 2])
              for step in range(SECOND_ITERS)
              for active in [next((lv for end, lv in SECOND_C2F if step < end), 16)]]
    print(f"[compose] second object '{SECOND}' (radius {BALL[1]} at {BALL[0]}): main_nerf -O2 --c2f {c2f} "
          f"(grad_level_phases {trainer.grad_level_phases}) --iters {SECOND_ITERS} in {time.time() - t0:.1f} s with "
          f"loading and the eval of 1 val view; stage boundaries crossed at steps {[end for end, _ in SECOND_C2F]}; "
          + "; ".join(stages) + f" (epoch times, the first with its warm-up); loss last 50 steps "
          f"{sum(trainer.step_losses[-50:]) / 50:.5f}, val PSNR {trainer.last_eval_results['PSNR']:.3f} dB; table "
          f"gradient columns per launch {sorted(set(columns))}; launches {launches}")
    if launches["hashgrid_table_grad"] != SECOND_ITERS or columns != want_j:
        raise AssertionError(f"-O2: {len(columns)} table-gradient launches with columns {columns}, want {want_j}")
    if launches["composite_rays_fused_backward"] != SECOND_ITERS:
        raise AssertionError(f"-O2: composite backward launched {launches}, want {SECOND_ITERS}")
    if not launches["composite_rays_resume"]:
        raise AssertionError(f"-O2: the eval's iterative renderer launched no composite_rays_resume: {launches}")
    check_encodes("-O2", launches, SECOND_ITERS)
    return ws, launches


def compose_layout(work: str, scale: float):
    """The composition root (``ws_<obj>/checkpoints`` of both trained
    objects, linked, and their sidecars under ``obj_feats/``, where
    ``combined`` reads them) and a val split of both spheres together, with
    occlusion, on cameras at COMPOSE_RADIUS."""
    root = os.path.join(work, "compose_root")
    os.makedirs(os.path.join(root, "obj_feats"))
    for obj, ws in ((OBJECT, "train_ws"), (SECOND, f"{SECOND}_ws")):
        os.symlink(os.path.join(work, f"{ws}_{obj}"), os.path.join(root, f"ws_{obj}"))
        shutil.copy(os.path.join(work, ws, "obj_feats", f"{obj}.npz"), os.path.join(root, "obj_feats"))
    scene = os.path.join(work, "compose_scene")
    write_training_scene(scene, scale, obj="scene", spheres=(SPHERE, BALL), splits=("val",), radius=COMPOSE_RADIUS)
    return root, scene


class PlainCompositorGuard:
    """Records each call of the plain compositor (``composite_rays``,
    ``composite_weights``) that is given a CUDA tensor, while the block runs."""

    def __enter__(self):
        import torch

        from focnerf_tpu_torch.ops import composite as tcomp

        self.module, self.saved, self.cuda_calls = tcomp, (tcomp.composite_rays, tcomp.composite_weights), []

        def guard(fn):
            def guarded(*args, **kwargs):
                if any(torch.is_tensor(a) and a.is_cuda for a in (*args, *kwargs.values())):
                    self.cuda_calls.append(fn.__name__)
                return fn(*args, **kwargs)
            return guarded

        tcomp.composite_rays, tcomp.composite_weights = (guard(f) for f in self.saved)
        return self

    def __exit__(self, *exc):
        self.module.composite_rays, self.module.composite_weights = self.saved


def read_composition_log(path: str):
    """(per-view ms, {bg: {metric: value}}) from a composition's log.txt."""
    views, summary = [], {}
    with open(path) as f:
        for line in f:
            if line.startswith("view "):
                views.append(float(line.split(":")[1].split("ms")[0]))
            elif line.startswith("bg="):
                bg, rest = line.strip().split(": ", 1)
                summary[bg[3:]] = {k.strip(): float(v) for k, v in (p.split(" = ") for p in rest.split(" | "))}
    return views, summary


def run_composition_cli(tag: str, name: str, mod, argv, out: str, dev, smi: str, want=None):
    """One run of a composition CLI (``combined`` or ``editable``) writing
    to ``out``, under the plain-compositor guard, with the launch counts set
    to 0 just before it and read just after. Fails when the plain compositor
    saw a CUDA tensor, when the launches differ from ``want`` (None: when the
    composite forward never launched), or when a view's outputs are missing.
    Returns (launches, per-view ms, {bg: {metric: value}}, peak GiB)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    with PlainCompositorGuard() as guard, EncodeCalls() as encodes:
        frames = mod.main(argv, device=dev)
        torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_counts()
    if want is not None:  # every object's density, once a chunk: one encode launch a call
        want = dict(want, hashgrid_encode_forward=len(encodes.points))
    peak = torch.cuda.max_memory_allocated() / 2**30
    views_ms, summary = read_composition_log(os.path.join(out, "log.txt"))
    print(f"[{tag}] {name}: K=2 objects, {len(frames)} val views of {RES}x{RES} in "
          f"{wall:.2f} s with loading (per view {', '.join(f'{ms / 1e3:.4f}' for ms in views_ms)} s; "
          f"mean after the first {sum(views_ms[1:]) / max(len(views_ms) - 1, 1) / 1e3:.4f} s/view), peak "
          f"memory {peak:.3f} GiB, PSNR_w {summary['w']['PSNR']:.3f} dB, PSNR_b {summary['b']['PSNR']:.3f} dB, "
          f"SSIM_w {summary['w']['SSIM']:.4f}; launches {launches}; plain compositor calls on CUDA "
          f"tensors: {len(guard.cuda_calls)} ({smi})")
    launched = launches == want if want is not None else launches["composite_rays_fused"] > 0
    if not launched or guard.cuda_calls:
        raise AssertionError(f"{name}: launches {launches}, want {want or 'composite_rays_fused > 0'}; "
                             f"plain compositor on CUDA tensors {guard.cuda_calls}")
    for v in range(VAL_VIEWS):
        for sub in ("rgbs_w", "rgbs_b", "depth_w", "ground_truth_w"):
            if not os.path.exists(os.path.join(out, sub, f"{v:04d}.png")):
                raise AssertionError(f"{name}: no {sub}/{v:04d}.png")
    if mod.__name__.endswith("editable") and not (
            os.path.exists(os.path.join(out, "composite.mp4"))
            or os.path.exists(os.path.join(out, f"composite_{VAL_VIEWS - 1:04d}.png"))):
        raise AssertionError(f"{name} wrote neither composite.mp4 nor its PNG frames")
    return launches, views_ms, summary, peak


def phase_composition(work: str, dev, smi: str):
    """``combined`` over the val views of both spheres (occupancy path), then
    ``editable --edit_object SECOND --offset_x 0.3``: each composites every
    4096-ray chunk of every view through the forward kernel, and the plain
    compositor sees no CUDA tensor. Returns each run's launches and metrics."""
    from focnerf_tpu_torch.apps import combined, editable
    from focnerf_tpu_torch.config import parse_options

    root, scene = compose_layout(work, parse_options([work]).scale)
    chunks = math.ceil(RES * RES / CHUNK)
    want = dict(composite_rays_fused=chunks * VAL_VIEWS, composite_rays_resume=0, composite_rays_fused_backward=0,
                hashgrid_table_grad=0, march_rays_skip=0, hashgrid_input_grad=0)
    runs, results = {}, {}
    for name, mod, edit in (("combined", combined, []),
                            ("editable", editable, ["--edit_object", SECOND, "--offset_x", "0.3"])):
        out = os.path.join(work, f"{name}_out")
        runs[name], _, results[name], _ = run_composition_cli(
            "compose", " ".join([name] + edit), mod, [scene, "-O", "--ckpt_dir", root, "--workspace", out] + edit,
            out, dev, smi, want)
    if not results["combined"]["w"]["PSNR"] >= 20.0:
        raise AssertionError(f"composed PSNR_w {results['combined']['w']['PSNR']} dB, want >= 20")
    return runs, results, root, scene


def _compare(label: str, gpu, cpu):
    import torch

    if not all(torch.isfinite(t).all() for t in gpu):
        raise AssertionError(f"{label}: non-finite render on the card")
    diff = torch.cat([(g.cpu() - c).abs().reshape(-1) for g, c in zip(gpu, cpu)])
    far = float((diff > 1e-3).float().mean())
    print(f"[reference] {label}, card vs CPU: max_abs_err {float(diff.max()):.3g}, mean "
          f"{float(diff.mean()):.3g}, share > 1e-3: {far:.4f} (limits: mean 1e-4, share 0.01)")
    # sums in other orders and libm vs CUDA exp/pow; on the occupancy path a
    # candidate on a cell boundary may flip cells, which moves that ray's samples
    if not (float(diff.mean()) <= 1e-4 and far <= 0.01):
        raise AssertionError(f"{label}: card and CPU renders disagree")


def phase_composition_reference(root: str, scene: str, dev):
    """On the trained objects, in fp32: one 64x64 val view composed on the
    card (kernel) and on the CPU (plain versions) from the same checkpoints,
    plainly, with the translated edit and with a rotate_z 90 edit (uniform
    path, 512 steps); then, on the card, [A, A] against [A] (bit for bit)
    and [A] through ``compose_image`` against ``render_image`` of A (1e-5)."""
    import dataclasses

    import numpy as np
    import torch

    from focnerf_tpu_torch.apps.combined import load_composition
    from focnerf_tpu_torch.config import parse_options
    from focnerf_tpu_torch.data.provider import NeRFDataset
    from focnerf_tpu_torch.ops.composite import composite_rays_fused
    from focnerf_tpu_torch.render.compose import compose_image, rotation_matrices, union_occupancy_bits
    from focnerf_tpu_torch.render.renderer import render_image

    opt = parse_options([scene, "-O", "--ckpt_dir", root])
    pose = NeRFDataset(opt.dataset_options(), split="val", device="cpu").poses[0]
    size = 64  # the CPU renders the rotated edit through 512 uniform steps
    intr = np.array([1.2 * size, 1.2 * size, size / 2, size / 2], np.float32)
    loaded = {where: load_composition(opt, device=where) for where in (dev, "cpu")}
    objs, cfg = loaded[dev][:2]
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)  # no bf16 flips
    offsets = np.zeros((len(objs), 3), np.float32)
    offsets[objs.index(SECOND), 0] = 0.3
    degrees = np.zeros((len(objs), 3), np.float32)
    degrees[objs.index(SECOND), 2] = 90.0
    march = dict(dt_gamma=opt.dt_gamma, max_steps=opt.max_steps, slab=max(opt.train_slab, 64))
    cases = {
        "composition, occupancy path": (None, None, True),
        "translated edit (offset_x 0.3), occupancy path": (offsets, None, True),
        "rotate_z 90 edit, uniform path (512 steps)": (None, degrees, False),
    }
    for label, (offs, degs, occupancy) in cases.items():
        renders = {}
        for where, batch in ((dev, CHUNK), ("cpu", 1024)):
            _, _, params, feats, occ, _ = loaded[where]
            kw = dict(march, occ_bits=union_occupancy_bits(occ, offs, cfg.bound)) if occupancy else dict(num_steps=512)
            rots = None if degs is None else rotation_matrices(degs, device=where)
            composite_rays_fused.launches = 0
            t0 = time.time()
            renders[where] = compose_image(params, cfg32, pose, intr, size, size, feats, offs, rots, bg_color=0.0,
                                           max_ray_batch=batch, **kw)
            seconds = time.time() - t0
            if torch.device(where).type == "cuda" and composite_rays_fused.launches != math.ceil(size * size / CHUNK):
                raise AssertionError(f"{label}: {composite_rays_fused.launches} kernel launches on the card")
        print(f"[reference] {label}: {size}x{size} fp32 view, K=2, the CPU's render took {seconds:.1f} s; object share "
              f"{float((renders['cpu'][0][..., 3] > 0.5).float().mean()):.3f}")
        _compare(f"{label} (rgba, depth)", renders[dev], renders["cpu"])

    # identities on the card, at the CLI's (bf16) model
    _, _, params, feats, occ, _ = loaded[dev]
    k = objs.index(OBJECT)
    a, feat_a, bits_a = params[k], feats[k:k + 1], occ[k:k + 1]
    intr256 = np.array([307.2, 307.2, 128, 128], np.float32)
    common = dict(bg_color=0.0, **march)
    one = compose_image([a], cfg, pose, intr256, 256, 256, feat_a,
                        occ_bits=union_occupancy_bits(bits_a, None, cfg.bound), **common)
    two = compose_image([a, a], cfg, pose, intr256, 256, 256, feat_a.repeat(2, 1), np.zeros((2, 3), np.float32),
                        occ_bits=union_occupancy_bits(bits_a.repeat(2, 1, 1), np.zeros((2, 3)), cfg.bound), **common)
    same = torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])
    image, depth = render_image(a, cfg, pose, intr256, 256, 256, obj_feat=feat_a[0],
                                occ_bits=bits_a[0], **common)
    solo = max(float((one[0][..., :3] - image).abs().max()), float((one[1] - depth).abs().max()))
    print(f"[identity] 256x256 view on the card: composing [{OBJECT}, {OBJECT}] equals composing [{OBJECT}] "
          f"bit for bit: {same}; [{OBJECT}] composed against render_image of it (image, depth): max_abs_err "
          f"{solo:.3g} (limit 1e-5); object share {float((one[0][..., 3] > 0.5).float().mean()):.3f}")
    if not (same and solo <= 1e-5):
        raise AssertionError("composition identities fail on the card")
    return (cfg, params, feats, occ), march, pose


def phase_compose_profile(loaded, march, pose):
    """Where one composed 800x800 view's time goes (K=2, occupancy path, the
    CLI's model, ``loaded`` on the card; the CLIs warmed this path up):
    CUDA events around each stage the compositor calls, then the same
    camera at a quarter of the resolution under torch.profiler (device busy
    share, top kernels)."""
    import collections

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from focnerf_tpu_torch.models import nerf
    from focnerf_tpu_torch.render import compose
    from focnerf_tpu_torch.utils.measure import busy_ms, device_events

    cfg, params, feats, occ = loaded
    intr = np.array([1.2 * RES, 1.2 * RES, RES / 2, RES / 2], np.float32)
    kw = dict(occ_bits=compose.union_occupancy_bits(occ, None, cfg.bound), bg_color=0.0, **march)

    def view():
        compose.compose_image(params, cfg, pose, intr, RES, RES, feats, **kw)
        torch.cuda.synchronize()

    spans = collections.defaultdict(list)
    patched = [(compose, n) for n in ("near_far_from_aabb", "march_rays", "density_fn", "color_fn",
                                      "encode_objfeat", "composite_rays_fused")] + [(nerf, "hashgrid_encode_c2f")]
    saved = [(m, n, getattr(m, n)) for m, n in patched]

    def timed(name, fn):
        def run(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            spans[name].append((start, end))
            return out
        return run

    for m, n, fn in saved:
        setattr(m, n, timed(n, fn))
    try:
        t0 = time.perf_counter()
        view()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)
    stage = {n: sum(s.elapsed_time(e) for s, e in v) for n, v in spans.items()}
    print(f"[compose-profile] one {RES}x{RES} composed view (K=2, occupancy path), wall {wall:.1f} ms; event spans "
          "(ms, share of wall; hashgrid_encode_c2f is inside density_fn): "
          + ", ".join(f"{n} {ms:.1f} ({ms / wall:.1%}, {len(spans[n])} calls)" for n, ms in
                      sorted(stage.items(), key=lambda kv: -kv[1])))
    # the profiled view is a sixteenth of the pixels (the same camera at a
    # quarter of the resolution): the profiler's host-side processing of an
    # 800x800 view's ~195k device events took ~70 s of the smoke's time
    # limit, of a 400x400 view's ~50k some 18 s
    small = RES // 4
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        compose.compose_image(params, cfg, pose, intr / 4, small, small, feats, **kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    busy = busy_ms(prof)
    by_name = collections.Counter()
    for name, ms in events:
        by_name[name] += ms
    print(f"[compose-profile] a {small}x{small} composed view under torch.profiler: wall {wall:.1f} ms, device busy "
          f"{busy:.1f} ms ({busy / wall:.1%}; idle {1 - busy / wall:.1%}), {len(events)} device events")
    for name, ms in by_name.most_common(6):
        print(f"[compose-profile]   {ms:8.2f} ms {ms / busy:6.1%}  {name[:110]}")
    ms = sum(v for k, v in by_name.items() if "composite_forward_kernel" in k)
    print(f"[compose-profile]   kernel composite_forward_kernel: {ms:.3f} ms ({ms / max(busy, 1e-9):.2%} of "
          "device time)")


def blob_volume(R: int, sh_deg: int = 0, seed: int = 0, device="cpu"):
    """An analytic two-blob volume [R, R, R, 3 * max(sh_deg, 1)^2 + 1] in
    [-1, 1]^3: hard-edged spheres of sigma 40 and 25 in a payload drawn from
    ``seed`` (rgb in [0, 1], or SH coefficients in [-0.5, 0.5])."""
    import torch

    g = torch.Generator().manual_seed(seed)
    c = (torch.arange(R, dtype=torch.float32) + 0.5) / R * 2 - 1
    X, Y, Z = torch.meshgrid(c, c, c, indexing="ij")
    sigma = (torch.where((X - 0.2) ** 2 + Y**2 + Z**2 < 0.3**2, 40.0, 0.0)
             + torch.where((X + 0.3) ** 2 + (Y - 0.2) ** 2 + (Z + 0.1) ** 2 < 0.25**2, 25.0, 0.0))
    payload = torch.rand((R, R, R, 3 * max(sh_deg, 1) ** 2), generator=g) - (0.5 if sh_deg else 0.0)
    return torch.cat([payload, sigma[..., None]], -1).to(device)


def axis_poses(distance: float = 2.5):
    """Six c2w poses, one per principal axis and sign, looking at the origin
    from slightly off-axis eyes (+z forward, +y down)."""
    import numpy as np

    poses = []
    for ax in range(3):
        for sign in (1.0, -1.0):
            eye = np.array([0.3, -0.2, 0.1])
            eye[ax] = distance * sign
            fwd = -eye / np.linalg.norm(eye)
            right = np.cross(fwd, (1.0, 0.0, 0.0) if ax == 1 else (0.0, 1.0, 0.0))
            right /= np.linalg.norm(right)
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = np.stack([right, np.cross(fwd, right), fwd], -1)
            pose[:3, 3] = eye
            poses.append(pose)
    return poses


def _psnr(a, b) -> float:
    return float(-10.0 * math.log10(max(float(((a.double() - b.double()) ** 2).mean()), 1e-20)))


def phase_baked_reference(dev):
    """The shear-warp renderer on the card against the CPU, small: an
    analytic two-blob volume at 64^3, 96x96 views from six poses (every
    axis and flip), dense with sh_deg 0 and 2 and uint8-resident. The core
    in fp32 on the card must pass the render gates against the CPU's fp32
    render; ``render_baked`` on the card (bf16 resampling) must be within
    BAKED_BF16_PSNR dB of it. Then the edits on the card against the CPU:
    shift, rotation by 90 degrees and merge to the bit, rotation by 30
    degrees within 1e-5 relative."""
    import numpy as np
    import torch

    from focnerf_tpu_torch.render import baked as tb

    R, size = 64, 96
    intr = np.array([115.2, 115.2, 48.0, 48.0], np.float32)
    worst = float("inf")
    for label, sh_deg, resident in (("dense sh0", 0, False), ("dense sh2", 2, False), ("uint8-resident sh0", 0, True)):
        cpu = tb.BakedVolume(rgba=blob_volume(R, sh_deg, seed=sh_deg), bound=1.0, sh_deg=sh_deg)
        if resident:
            cpu = tb.quantize_volume(cpu)
        card = type(cpu)(*(t.to(dev) if torch.is_tensor(t) else t for t in cpu))
        core32, bf16 = [], []
        for pose in axis_poses():
            want = tb.render_baked(cpu, pose, intr, size, size)
            axis, flip = tb.view_axis(pose, 1.0)
            rgba = card.q if resident else card.rgba
            got32 = tb._render_core(
                rgba, 1.0, torch.from_numpy(pose).to(dev), torch.from_numpy(intr).to(dev), axis=axis, flip=flip,
                H=size, W=size, ri=2 * R, bg_color=1.0, density_scale=1.0, sh_deg=sh_deg,
                quant=(card.scales, card.los) if resident else None, compute_dtype=torch.float32)
            core32.append((got32, want))
            got = tb.render_baked(card, pose, intr, size, size)
            bf16.append(_psnr(got[0].cpu(), want[0]))
            if not all(torch.isfinite(t).all() for t in got):
                raise AssertionError(f"{label}: non-finite bf16 render on the card")
        _compare(f"shear-warp core in fp32, {label}, 6 poses (image, depth, alpha)",
                 tuple(torch.cat([g[i].reshape(-1) for g, _ in core32]) for i in range(3)),
                 tuple(torch.cat([w[i].reshape(-1) for _, w in core32]) for i in range(3)))
        worst = min(worst, min(bf16))
        print(f"[baked-reference] render_baked on the card (bf16 resampling) against the CPU (fp32), {label}: "
              f"image PSNR per pose {', '.join(f'{p:.2f}' for p in bf16)} dB (limit >= {BAKED_BF16_PSNR})")
    if not worst >= BAKED_BF16_PSNR:
        raise AssertionError(f"bf16 shear-warp on the card {worst:.2f} dB from the CPU's fp32, want >= "
                             f"{BAKED_BF16_PSNR}")

    rgba = blob_volume(R, seed=5)
    rgba[0, :, :, -1] = 30.0  # mass on a face: rotated corners leave the cube
    cpu = tb.BakedVolume(rgba=rgba, bound=1.0)
    card = tb.BakedVolume(rgba=rgba.to(dev), bound=1.0)
    other = blob_volume(R, seed=6)
    other[..., -1] = torch.where(torch.arange(R)[:, None, None] % 2 == 0, rgba[..., -1], other[..., -1])  # ties
    edits = {
        "shift_volume (0.5, -1.5, 2.5 voxels)": (lambda v: tb.shift_volume(v, (1 / 64, -3 / 64, 5 / 64)), True),
        "rotate_volume 90 about y": (lambda v: tb.rotate_volume(v, 1, 90.0), True),
        "merge_volumes with ties": (lambda v: tb.merge_volumes([v, tb.BakedVolume(other.to(v.rgba.device), 1.0)]),
                                    True),
        "rotate_volume 30 about z": (lambda v: tb.rotate_volume(v, 2, 30.0), False),
        "rotate_volume 30 about x, centre (0.1, 0, -0.2)": (lambda v: tb.rotate_volume(v, 0, 30.0, (0.1, 0.0, -0.2)),
                                                            False),
    }
    for label, (fn, exact) in edits.items():
        got, want = fn(card).rgba.cpu(), fn(cpu).rgba
        err = float((got - want).abs().max())
        ok = torch.equal(got, want) if exact else torch.allclose(got, want, rtol=1e-5, atol=1e-5)
        print(f"[baked-reference] {label} on the card against the CPU at {R}^3: max_abs_err {err:.3g} "
              f"(limit {'0, to the bit' if exact else '1e-5 + 1e-5 relative'})")
        if not ok:
            raise AssertionError(f"{label}: the card and the CPU disagree")


def read_baked_log(path: str):
    """The ``[baked]`` lines of a composition's log.txt."""
    with open(path) as f:
        return [line.strip() for line in f if line.startswith("[baked]")]


def phase_baked_compose(work: str, root: str, scene: str, dev, smi: str, per_sample: dict):
    """``combined --baked`` over the val views of both spheres (each object
    baked at 256^3, its gate report written, merged, every view rendered by
    shear-warp), then ``editable --baked --bake_quantize --edit_object
    SECOND --offset_x 0.3 --rotate_z 90`` (uint8-resident), through the same
    runner as phase 7. Each object's bake_quality.json must be written, the
    composite forward (the gate's exact probes) must launch, no CUDA tensor
    may reach the plain compositor, and PSNR_w must be >= 20 dB. Returns
    each run's launches and the two merged volumes (dense, resident)."""
    import json as _json

    from focnerf_tpu_torch.apps import combined, editable

    volumes = []
    bake = combined.bake_composition

    def keep(*args, **kwargs):  # the merged volume, for the profile phase
        volumes.append(bake(*args, **kwargs))
        return volumes[-1]

    runs = {}
    combined.bake_composition = keep
    try:
        for name, mod, edit in (
                ("combined", combined, ["--baked"]),
                ("editable", editable, ["--baked", "--bake_quantize", "--edit_object", SECOND, "--offset_x", "0.3",
                                        "--rotate_z", "90"])):
            out = os.path.join(work, f"baked_{name}_out")
            gates = [os.path.join(root, f"ws_{obj}", "bake_quality.json") for obj in (OBJECT, SECOND)]
            for path in gates:
                if os.path.exists(path):
                    os.remove(path)
            runs[name], views_ms, summary, peak = run_composition_cli(
                "baked-compose", " ".join([name] + edit), mod,
                [scene, "-O", "--ckpt_dir", root, "--workspace", out] + edit, out, dev, smi)
            for line in read_baked_log(os.path.join(out, "log.txt")):
                print(f"[baked] {name}: {line[len('[baked] '):]}")
            frame_ms = sum(views_ms[1:]) / max(len(views_ms) - 1, 1)
            print(f"[baked] {name}: {frame_ms:.2f} ms per {RES}x{RES} frame after the first view (host clock, the "
                  f"PNG and metric work of a view excluded); peak memory {peak:.3f} GiB; composite forward "
                  f"launches {runs[name]['composite_rays_fused']} ({smi})")
            ref = per_sample["combined"]
            print(f"[baked] {name}: PSNR_w {summary['w']['PSNR']:.3f} / PSNR_b {summary['b']['PSNR']:.3f} dB; the "
                  f"per-sample combined of phase 7 on the same views {ref['w']['PSNR']:.3f} / "
                  f"{ref['b']['PSNR']:.3f} dB")
            for path, obj in zip(gates, (OBJECT, SECOND)):
                if not os.path.exists(path):
                    raise AssertionError(f"{name}: no {path}")
                with open(path) as f:
                    rep = _json.load(f)
                print(f"[baked] {name}: {obj} bake gate psnr_baked_vs_exact_mean {rep['psnr_baked_vs_exact_mean']}"
                      f" dB, min {rep['psnr_baked_vs_exact_min']} dB over {rep['views']} probe views of "
                      f"{rep['probe_hw'][0]}x{rep['probe_hw'][1]}")
            if name == "combined" and not summary["w"]["PSNR"] >= 20.0:
                raise AssertionError(f"baked composition PSNR_w {summary['w']['PSNR']} dB, want >= 20")
    finally:
        combined.bake_composition = bake
    return runs, volumes


def phase_baked_profile(volumes, pose, dev, smi: str):
    """Where one 800x800 shear-warp frame's time goes at 256^3, after a
    warm-up frame: dense (the merged composition), uint8-resident (the
    edited one) and a dense sh_deg 2 volume (the analytic blobs). CUDA events
    around each stage: the relayout (permute, flip, cast), the dequant
    (resident), the hat matrices, the two resample products, the fold
    arithmetic, the SH contraction and the final warp; then 5 frames under
    torch.profiler for the device's busy share and top kernels."""
    import collections

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from focnerf_tpu_torch.render import baked as tb
    from focnerf_tpu_torch.utils.measure import busy_ms, device_events

    intr = np.array([1.2 * RES, 1.2 * RES, RES / 2, RES / 2], np.float32)
    R = volumes[0].rgba.shape[0]
    sh2 = tb.BakedVolume(rgba=blob_volume(R, 2, seed=9, device=dev), bound=volumes[0].bound, sh_deg=2)
    stages = ("_relayout", "_dequant", "_hat_matrices", "_resample", "_accumulate", "sh_contract_plane", "_warp")
    for label, vol in (("dense sh0", volumes[0]), ("uint8-resident sh0", volumes[1]), ("dense sh2", sh2)):
        def frame():
            out = tb.render_baked(vol, pose, intr, RES, RES, bg_color=0.0)
            torch.cuda.synchronize()
            return out

        frame()  # warm-up
        spans = collections.defaultdict(list)
        saved = {n: getattr(tb, n) for n in stages}

        def timed(name, fn):
            def run(*args, **kwargs):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kwargs)
                end.record()
                spans[name].append((start, end))
                return out
            return run

        for n, fn in saved.items():
            setattr(tb, n, timed(n, fn))
        try:
            t0 = time.perf_counter()
            frame()
            wall = (time.perf_counter() - t0) * 1e3
        finally:
            for n, fn in saved.items():
                setattr(tb, n, fn)
        stage = {n: sum(s.elapsed_time(e) for s, e in spans[n]) for n in stages if spans[n]}
        rest = wall - sum(stage.values())
        data = vol.q if isinstance(vol, tb.QuantizedVolume) else vol.rgba
        print(f"[baked-profile] {label}, volume {tuple(data.shape)} {data.dtype}, one {RES}x{RES} frame (ri "
              f"{2 * data.shape[0]}), wall {wall:.2f} ms; stage event spans (ms, share of "
              "wall): " + ", ".join(f"{n.strip('_')} {ms:.3f} ({ms / wall:.1%}, {len(spans[n])} calls)"
                                    for n, ms in stage.items())
              + f", outside the stages {rest:.3f} ({rest / wall:.1%}) ({smi})")
        n_frames = 5
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_frames):
                frame()
            wall = (time.perf_counter() - t0) * 1e3 / n_frames
        busy = busy_ms(prof) / n_frames
        by_name = collections.Counter()
        for name, ms in device_events(prof):
            by_name[name] += ms / n_frames
        print(f"[baked-profile] {label} under torch.profiler: wall {wall:.2f} ms/frame, device busy {busy:.2f} "
              f"ms/frame ({busy / wall:.1%}; idle {1 - busy / wall:.1%}; the union of the device events' intervals)")
        for name, ms in by_name.most_common(5):
            print(f"[baked-profile]   {ms:8.3f} ms/frame {ms / busy:6.1%}  {name[:110]}")


def phase_procedural(work: str, dev, smi: str):
    """``make_hard_scene`` on the card at gt_res 256 and 800x800 with 4
    train, 2 val and 2 test views: ms per GT frame, and a val PNG must
    decode to within 1/255 of the frame rendered again from its pose."""
    import json as _json

    import numpy as np
    import torch

    from focnerf_tpu_torch.core.camera import nerf_matrix_to_ngp
    from focnerf_tpu_torch.data.png import read_image
    from focnerf_tpu_torch.data.procedural import hard_volume, make_hard_scene
    from focnerf_tpu_torch.render.baked import BakedVolume, render_baked

    root = os.path.join(work, "hard_scene")
    t0 = time.time()
    make_hard_scene(root, n_train=4, n_val=2, n_test=2, H=RES, W=RES, gt_res=GT_RES, device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    with open(os.path.join(root, "transforms_val.json")) as f:
        frame = _json.load(f)["frames"][0]
    pose = nerf_matrix_to_ngp(np.asarray(frame["transform_matrix"], np.float32), scale=1.0)
    vol = BakedVolume(rgba=torch.from_numpy(hard_volume(GT_RES)).to(dev), bound=1.0)
    intr = (1.2 * RES, 1.2 * RES, RES / 2.0, RES / 2.0)
    render_baked(vol, pose, intr, RES, RES)  # warm-up
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(5):
        img, _, alpha = render_baked(vol, pose, intr, RES, RES, bg_color=1.0)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t1) * 1e3 / 5
    rgba = torch.cat([img, alpha[..., None]], -1).clamp(0, 1).cpu().numpy()
    png = read_image(os.path.join(root, frame["file_path"] + ".png")).astype(np.float32) / 255.0
    err = float(np.abs(png - rgba).max())
    print(f"[procedural] make_hard_scene at gt_res {GT_RES}, 8 views of {RES}x{RES}: {wall:.2f} s with the volume, the "
          f"PNG writes and the JSON; {frame_ms:.2f} ms per GT frame (render_baked, synchronized, mean of 5); val "
          f"PNG against the re-rendered frame: max_abs_err {err:.5f} (limit 1/255 = {1 / 255:.5f}); object share "
          f"{float((alpha > 0.5).float().mean()):.3f} ({smi})")
    if not (png.shape == (RES, RES, 4) and err <= 1 / 255 + 1e-6):
        raise AssertionError(f"procedural val PNG {png.shape} off the rendered frame by {err}")


# PARITY.md:25's budget; the dynamic families' smoke depth (cut from 200,
# then from 100 to pay for [parallel]: their gate is a finite val PSNR)
VOXEL_ITERS, DYN_ITERS = 300, 50
# the VM run's steps (cut from VOXEL_ITERS to pay for [parallel]: at 300 its
# loss fell 50x and its val PSNR read 27.78 dB, against gates of 2x and 20 dB)
VM_ITERS = 150
VOXEL_RES, VM_RES = 256, 128  # the dense field at the default --bake_res; VM (and dynamic) at bench.py's 128^3
DENSE_C2F = 3  # the dense run's c2f stages (64, 128, 256)
DYN_RES, DYN_GT_RES = 400, 128  # harddyn_400_128 (tools/parity.py, --res 400 --views 30)
VOXEL_REF_LOSS, VOXEL_REF_GRAD, VOXEL_REF_BF16 = 1e-4, 1e-3, 1e-2  # card fp32 / bf16 step against the CPU


def run_voxel_cli(tag: str, argv, dev, smi: str, final_steps: int = 0):
    """``main_voxel`` on the card through its entry point: prints ms/step
    (of the last ``final_steps`` steps, a c2f run's full-resolution stage,
    whose seconds ``info`` holds; 0: all), supervised rays/s, peak memory,
    the train mse at both ends of the run, the val PSNR and the kernel
    launches (the voxel path runs neither kernel). Returns (info, launches,
    first mse, last mse)."""
    import numpy as np
    import torch

    from focnerf_tpu_torch.apps import main_voxel

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    _, info = main_voxel.main(argv, device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    mse = info["step_mse"]
    n = max(len(mse) // 10, 1)
    first, last = float(mse[:n].mean()), float(mse[-n:].mean())
    val = info.get("val_psnr")
    steps = final_steps or len(mse)
    stages = f"; stage train PSNRs {[round(p, 2) for p in info['stage_psnrs']]} dB" if "stage_psnrs" in info else ""
    print(f"[voxel] {tag}: {len(mse)} steps; {steps} {'final-stage ' if final_steps else ''}steps in "
          f"{info['seconds']:.2f} s ({info['seconds'] / steps * 1e3:.2f} ms/step, {info['rays_per_sec']:.0f} "
          f"supervised rays/s; the first step's set-up and the GT pre-warps included), {wall:.2f} s with loading, "
          f"every stage, saving, mesh and val; peak memory {peak:.3f} GiB; train mse first {n} steps {first:.5f}, "
          f"last {n} {last:.5f}{stages}; val PSNR {val if val is None else round(val, 3)} dB; kernel launches "
          f"{launches} ({smi})")
    if not (np.isfinite(mse).all() and val is not None and np.isfinite(val)):
        raise AssertionError(f"{tag}: non-finite training mse or val PSNR {val}")
    return info, launches, first, last


def phase_voxel(work: str, dev, smi: str) -> dict:
    """``main_voxel`` on the card at full width: dense VOXEL_RES^3 on phase
    5's sphere scene (VOXEL_ITERS steps on the c2f ladder of DENSE_C2F
    stages, remat on, 800x800 views), then 20 steps at VOXEL_RES^3 with
    remat on and off for their time and peak memory; VM rank 16 at
    VM_RES^3 with ``--bake_quantize``; ``--voxel_dynamic`` and
    ``--voxel_kplanes 8`` at VM_RES^3 on the dynamic hard scene (DYN_RES^2
    views, GT at DYN_GT_RES^3). The dense and VM runs must halve their train
    loss and reach 20 dB on the val views; every run must write a finite
    val PSNR. Returns the kernel launches summed over the runs."""
    import numpy as np
    import torch

    from focnerf_tpu_torch.apps.main_voxel import _rgb_on_white
    from focnerf_tpu_torch.config import parse_options
    from focnerf_tpu_torch.data.procedural import make_hard_dynamic_scene
    from focnerf_tpu_torch.data.provider import DatasetOptions, NeRFDataset
    from focnerf_tpu_torch.train.voxel import _c2f_stage_plan, fit_voxels

    # phase 5's scene was written at the default --scale: read with it, the
    # sphere (radius 0.8) sits in the [-1, 1] box and every camera (radius 3)
    # outside it, the geometry --scale 1.0 gives a scene written in ngp units
    scene, scale = os.path.join(work, "train_scene"), parse_options(["x"]).scale
    total = dict.fromkeys(counters(), 0)
    common = ["--scale", str(scale), "--bound", "1.0", "--iters", str(VOXEL_ITERS)]
    # at main_voxel's defaults the dense field needs more than VOXEL_ITERS
    # steps at 256^3 (PERF.md §6); the c2f ladder reaches the gate in them
    ladder = _c2f_stage_plan(VOXEL_RES, DENSE_C2F, VOXEL_ITERS)
    for tag, name, extra, final in (
            (f"dense {VOXEL_RES}^3 (--voxel_c2f {DENSE_C2F}: {', '.join(str(r) for r, _ in ladder)}; "
             f"--steps_per_dispatch {FUSED_VOXEL_K})", "dense",
             ["--bake_res", str(VOXEL_RES), "--voxel_c2f", str(DENSE_C2F), "--steps_per_dispatch",
              str(FUSED_VOXEL_K)], ladder[-1][1]),
            (f"VM rank 16 at {VM_RES}^3, --bake_quantize", "vm",
             ["--bake_res", str(VM_RES), "--voxel_vm", "16", "--bake_quantize", "--iters", str(VM_ITERS)], 0)):
        ws = os.path.join(work, f"voxel_{name}")
        info, launches, first, last = run_voxel_cli(tag, [scene, "--workspace", ws] + common + extra, dev, smi,
                                                    final)
        total = {k: total[k] + v for k, v in launches.items()}
        res = VOXEL_RES if name == "dense" else VM_RES
        for f in (f"baked_{res}_sh0.npz", "mesh.obj"):
            if not os.path.exists(os.path.join(ws, f)):
                raise AssertionError(f"{tag}: no {f}")
        if name == "vm":
            rep = info["quantization_report"]
            print(f"[voxel] {tag}: uint8 against float volume {rep['psnr_quantized_vs_float_mean']} dB mean, "
                  f"{rep['psnr_quantized_vs_float_min']} min over {rep['views']} probe views; "
                  f"vmfield {os.path.getsize(os.path.join(ws, f'vmfield_{VM_RES}_r16.npz')) / 2**20:.1f} MiB")
        if not last < 0.5 * first:
            raise AssertionError(f"{tag}: the train loss did not halve ({first} -> {last})")
        if not info["val_psnr"] >= 20.0:
            raise AssertionError(f"{tag}: val PSNR {info['val_psnr']} dB, want >= 20")

    ds = NeRFDataset(DatasetOptions(path=scene, scale=scale), split="train", device=dev)
    imgs = _rgb_on_white(ds)
    for remat in (True, False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, info = fit_voxels(ds.poses, imgs, ds.intrinsics, resolution=VOXEL_RES, iters=20, remat=remat, device=dev)
        torch.cuda.synchronize()
        print(f"[voxel] dense {VOXEL_RES}^3, 20 steps with remat {'on' if remat else 'off'}: "
              f"{info['seconds'] / 20 * 1e3:.2f} ms/step, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB ({smi})")
    del ds, imgs

    t0 = time.time()
    dscene = make_hard_dynamic_scene(os.path.join(work, f"harddyn_{DYN_RES}_{DYN_GT_RES}"), n_times=7,
                                     views_per_time=4, H=DYN_RES, W=DYN_RES, gt_res=DYN_GT_RES, device=dev)
    print(f"[voxel] dynamic hard scene: 7 times x 4 train views, 4 val, 4 test of {DYN_RES}x{DYN_RES} (GT at "
          f"{DYN_GT_RES}^3) written in {time.time() - t0:.1f} s")
    for tag, flags in ((f"--voxel_dynamic at {VM_RES}^3", ["--voxel_dynamic"]),
                       (f"--voxel_kplanes 8 at {VM_RES}^3", ["--voxel_kplanes", "8"])):
        ws = os.path.join(work, "voxel_" + flags[0].strip("-"))
        argv = [dscene, "--workspace", ws, "--bake_res", str(VM_RES), "--scale", "1.0", "--bound", "1.0",
                "--iters", str(DYN_ITERS)] + flags
        _, launches, _, _ = run_voxel_cli(tag, argv, dev, smi)
        total = {k: total[k] + v for k, v in launches.items()}
    if total["hashgrid_encode_forward"] or total["hashgrid_input_grad"]:
        raise AssertionError(f"[voxel] the voxel runs launched an encode kernel: {total}")
    return total


def _loss_and_grads(loss_fn, params, pose, t, target, mask):
    """(loss, [gradient of each leaf]) of one evaluation of ``loss_fn``."""
    from focnerf_tpu_torch.train.voxel import _leaves, _rebuild

    leaves = [p.detach().clone().requires_grad_(True) for p in _leaves(params)]
    loss, _ = loss_fn(_rebuild(params, leaves), pose, t, target, mask)
    loss.backward()
    return float(loss.detach()), [p.grad.detach().cpu().double() for p in leaves]


def phase_voxel_reference(dev):
    """One dense and one K-planes train step at 32^3 on 64x64 views, on the
    card against the CPU: the loss and the gradient of every parameter in
    fp32 (compute_dtype float32) within VOXEL_REF_LOSS / VOXEL_REF_GRAD, and
    the card's default bf16 step's loss within VOXEL_REF_BF16."""
    import numpy as np
    import torch

    from focnerf_tpu_torch.render import baked as tb
    from focnerf_tpu_torch.train import voxel as tvox
    from focnerf_tpu_torch.train import voxel_kplanes as tkp

    R, size = 32, 64
    intr = np.array([1.2 * size, 1.2 * size, size / 2, size / 2], np.float32)
    gt = tb.BakedVolume(rgba=blob_volume(64, seed=3), bound=1.0)
    g = torch.Generator().manual_seed(11)
    raw = torch.randn((R, R, R, 4), generator=g) * 0.5
    raw[..., -1] += 1.0
    families = (("dense", raw, lambda p, t: p, lambda p: 1e-4 * tvox.tv_loss(p)),
                ("K-planes rank 8", tkp.init_kplanes_field(R, rank=8, time_res=16, init_scale=0.3, w0=0.5,
                                                           generator=g, device="cpu"),
                 tkp.collapse_kplanes, lambda p: tkp.kplanes_reg(p, 1e-4, 1e-3)))
    for pose in (axis_poses()[1], axis_poses()[4]):
        img = tb.render_baked(gt, pose, intr, size, size, bg_color=1.0)[0]
        axis, flip = tb.view_axis(pose, 1.0)
        cpu_target = tb.warp_gt_to_intermediate(img, pose, intr, 1.0, axis=axis, flip=flip, ri=2 * R)
        card_target = tuple(x.to(dev) for x in cpu_target)
        for label, params, raw_fn, reg_fn in families:
            kw = dict(raw_fn=raw_fn, reg_fn=reg_fn, bound=1.0, sh_degree=0, ri=2 * R, bg_color=1.0,
                      density_scale=1.0, remat=True, supervise="intermediate")
            card_params = type(params)(*(p.to(dev) for p in params)) if not torch.is_tensor(params) \
                else params.to(dev)
            want = _loss_and_grads(tvox._make_loss(axis, flip, **kw), params, torch.from_numpy(pose), 0.4,
                                   *cpu_target)
            got32 = _loss_and_grads(tvox._make_loss(axis, flip, compute_dtype=torch.float32, **kw), card_params,
                                    torch.from_numpy(pose).to(dev), 0.4, *card_target)
            got16 = _loss_and_grads(tvox._make_loss(axis, flip, **kw), card_params, torch.from_numpy(pose).to(dev),
                                    0.4, *card_target)
            rel = lambda a, b: float((a - b).norm() / max(float(b.norm()), 1e-30))  # noqa: E731
            loss32, loss16 = abs(got32[0] - want[0]) / abs(want[0]), abs(got16[0] - want[0]) / abs(want[0])
            grad32 = max(rel(a, b) for a, b in zip(got32[1], want[1]))
            grad16 = max(rel(a, b) for a, b in zip(got16[1], want[1]))
            print(f"[voxel-reference] {label} train step at {R}^3, 64x64 view, axis {axis} flip {flip}: card fp32 "
                  f"against the CPU: loss rel err {loss32:.3g} (limit {VOXEL_REF_LOSS}), gradient rel L2 "
                  f"{grad32:.3g} (limit {VOXEL_REF_GRAD}); card bf16: loss rel err {loss16:.3g} (limit "
                  f"{VOXEL_REF_BF16}), gradient rel L2 {grad16:.3g}")
            if not (loss32 <= VOXEL_REF_LOSS and grad32 <= VOXEL_REF_GRAD and loss16 <= VOXEL_REF_BF16):
                raise AssertionError(f"voxel-reference {label}: the card's step disagrees with the CPU's")


def phase_voxel_profile(work: str, dev, smi: str):
    """Where one dense VOXEL_RES^3 train step's time goes (phase 5's scene,
    ri 2 VOXEL_RES, remat on, bf16 operands), after two warm-up steps: CUDA-event
    spans of the relayout, the hat matrices, the resample products and the
    fold (in the forward, and again in the backward's recompute), of the
    whole forward, backward and Adam; then 5 steps under torch.profiler
    for the device's busy share and top kernels."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    from focnerf_tpu_torch.apps.main_voxel import _rgb_on_white
    from focnerf_tpu_torch.config import parse_options
    from focnerf_tpu_torch.data.provider import DatasetOptions, NeRFDataset
    from focnerf_tpu_torch.render import baked as tb
    from focnerf_tpu_torch.train import voxel as tvox
    from focnerf_tpu_torch.utils.measure import busy_ms, device_events

    ds = NeRFDataset(DatasetOptions(path=os.path.join(work, "train_scene"), scale=parse_options(["x"]).scale),
                     split="train", device=dev)
    img, pose = _rgb_on_white(ds)[0], ds.poses[0]
    axis, flip = tvox._pose_variant(pose, 1.0)
    R, ri = VOXEL_RES, 2 * VOXEL_RES
    target = tb.warp_gt_to_intermediate(img, pose, ds.intrinsics, 1.0, axis=axis, flip=flip, ri=ri)
    raw = tvox.init_voxel_field(R, generator=torch.Generator().manual_seed(0), device=dev).requires_grad_(True)
    opt = torch.optim.Adam([raw], lr=5e-2, eps=1e-8)
    loss_fn = tvox._make_loss(axis, flip, raw_fn=lambda p, t: p, reg_fn=lambda p: 1e-4 * tvox.tv_loss(p), bound=1.0,
                              sh_degree=0, ri=ri, bg_color=1.0, density_scale=1.0, remat=True,
                              supervise="intermediate")
    pose_t = torch.from_numpy(pose).to(dev)
    spans = collections.defaultdict(list)
    where = ["forward"]

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def step(record: bool):
        where[0] = "forward"
        e0 = event()
        loss, _ = loss_fn(raw, pose_t, 0.0, *target)
        e1 = event()
        where[0] = "backward"
        loss.backward()
        e2 = event()
        opt.step()
        opt.zero_grad(set_to_none=True)
        e3 = event()
        if record:
            for name, a, b in (("forward", e0, e1), ("backward", e1, e2), ("Adam", e2, e3)):
                spans[name].append((a, b))

    stages = ("_relayout", "_hat_matrices", "_resample", "_accumulate")
    saved = {n: getattr(tb, n) for n in stages}

    def timed(name, fn):
        def run(*args, **kwargs):
            a = event()
            try:  # the backward's recompute may stop inside a stage once it has what it needs
                return fn(*args, **kwargs)
            finally:
                spans[f"{name.strip('_')} ({where[0]})"].append((a, event()))
        return run

    for _ in range(2):
        step(False)
    torch.cuda.synchronize()
    for n, fn in saved.items():
        setattr(tb, n, timed(n, fn))
    try:
        t0 = time.perf_counter()
        step(True)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        for n, fn in saved.items():
            setattr(tb, n, fn)
    ms = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}
    print(f"[voxel-profile] one dense {R}^3 train step (ri {ri}, remat on, bf16 operands), wall {wall:.2f} ms; "
          "CUDA-event spans (ms, share of wall): " + ", ".join(f"{k} {v:.3f} ({v / wall:.1%}, {len(spans[k])} calls)"
                                                               for k, v in ms.items()) + f" ({smi})")
    n_steps = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step(False)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n_steps
    busy = busy_ms(prof) / n_steps
    by_name = collections.Counter()
    for name, t in device_events(prof):
        by_name[name] += t / n_steps
    print(f"[voxel-profile] {n_steps} steps under torch.profiler: wall {wall:.2f} ms/step, device busy {busy:.2f} "
          f"ms/step ({busy / wall:.1%}; idle {1 - busy / wall:.1%})")
    for name, t in by_name.most_common(8):
        print(f"[voxel-profile]   {t:8.3f} ms/step {t / busy:6.1%}  {name[:110]}")


# the networks at 1e-3 and the grid at 1e-2, the D-NeRF reference's own split
# (dnerf/network.py:255-264): at main_dnerf's default (everything at 1e-2)
# the deformation net died (dx = 0 everywhere, no gradient left) in some
# runs of one tree, which then read 17.25-18.29 dB; at 1e-3 the nets need
# 700 steps (six runs 21.37-22.02 dB; one at 500 steps read 15.56; PERF.md §6)
DNERF_FLAGS = ("--lr_net", "1e-3")
DNERF_RES, DNERF_ITERS = 400, 700
DNERF_VIEWS = (("train", 50), ("val", 4), ("test", 4))  # 700 steps = 14 epochs
# the main run's time slots: 700 steps refresh one slot every 16, so 8 slots
# are each refreshed 5-6 times (at the default 64, slots past t = 0.5 would
# never be refreshed in 700 of the reference's 30000 steps)
DNERF_SLOTS = 8
DNERF_VARIANT_ITERS = {"basis": 20, "hyper": 20, "uniform": 20}
DNERF_PSNR = 18.0  # the [dnerf] val gate


def dnerf_sphere(t: float):
    """The dynamic scene's sphere at time t: radius 0.6 (ngp units), moving
    along x from -0.5 to 0.5, red below y = 0 and blue above."""
    return ((-0.5 + t, 0.0, 0.0), 0.6, (0.9, 0.2, 0.1), (0.1, 0.3, 0.9))


def write_dynamic_scene(root: str, scale: float):
    """A D-NeRF blender-layout scene of the moving sphere at DNERF_RES^2:
    DNERF_VIEWS views a split from random cameras at CAMERA_RADIUS, each
    frame with its ``time`` (train and test evenly over [0, 1], val at the
    middle of 4 quarters), RGBA with a transparent background. Frame names
    are zero-padded, so the JSON order is the sorted order both packages'
    providers agree on."""
    import numpy as np

    from focnerf_tpu_torch.core.camera import rand_poses
    from focnerf_tpu_torch.data.png import write_image

    rng = np.random.default_rng(11)
    for split, n in DNERF_VIEWS:
        os.makedirs(os.path.join(root, split), exist_ok=True)
        times = (np.arange(n) + 0.5) / n if split == "val" else np.linspace(0.0, 1.0, n)
        frames = []
        for i, (pose, t) in enumerate(zip(rand_poses(rng, n, radius=CAMERA_RADIUS), times)):
            rel = f"{split}/r_{i:03d}"
            write_image(os.path.join(root, rel + ".png"),
                        sphere_view(pose, 1.2 * DNERF_RES, (dnerf_sphere(float(t)),), res=DNERF_RES))
            frames.append({"file_path": rel, "time": float(t), "transform_matrix": _ngp_to_nerf(pose, scale).tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 2 * math.atan(1 / 2.4), "frames": frames}, f)
    return root


def _faces(path: str) -> int:
    with open(path) as f:
        return sum(line.startswith("f ") for line in f)


def phase_dnerf(work: str, dev, smi: str):
    """``main_dnerf <scene> -O --dnerf_variant deform`` at full width for
    DNERF_ITERS steps on the moving sphere, with its val split, then
    ``--test`` from its checkpoint. Each step must launch the composite
    forward at least once and the composite backward and the table gradient
    exactly once; the loss must halve, the val PSNR reach DNERF_PSNR, the
    time grid be refreshed (more than one slot non-zero), the meshes at
    t = 0 and t = 1 and the checkpoint exist, and ``--test`` render every
    test view (one composite launch per 4096-ray chunk) and the video; then
    3 more steps under torch.profiler (``[dnerf-profile]``). Returns (the
    training run's launches, the trainer)."""
    import glob

    import numpy as np
    import torch

    from focnerf_tpu_torch.apps import main_dnerf
    from focnerf_tpu_torch.config import parse_options
    from focnerf_tpu_torch.data.dnerf_provider import DNeRFDataset
    from focnerf_tpu_torch.train.checkpoints import CheckpointManager
    from focnerf_tpu_torch.train.dnerf_trainer import DNeRFTrainer

    scene, ws = os.path.join(work, "dnerf_scene"), os.path.join(work, "dnerf_ws")
    argv = [scene, "-O", "--dnerf_variant", "deform", "--workspace", ws, "--iters", str(DNERF_ITERS),
            "--time_slots", str(DNERF_SLOTS), "--ckpt_interval", "1000", *DNERF_FLAGS]
    opt = parse_options(argv)
    t0 = time.time()
    write_dynamic_scene(scene, opt.scale)
    print(f"[dnerf] moving-sphere scene: {', '.join(f'{n} {s}' for s, n in DNERF_VIEWS)} views of "
          f"{DNERF_RES}x{DNERF_RES} written in {time.time() - t0:.1f} s")

    ends, real = [], DNeRFTrainer._train_step

    def timed(self, ds):  # the host clock at the end of every train step
        out = real(self, ds)
        ends.append(time.perf_counter())
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    DNeRFTrainer._train_step = timed
    t0 = time.perf_counter()
    try:
        with SMClocks() as clocks:
            trainer = main_dnerf.main(argv, device=dev)
            torch.cuda.synchronize()
    finally:
        DNeRFTrainer._train_step = real
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = np.asarray(trainer.step_losses)
    steps = len(losses)
    dt = np.diff(np.asarray([t0] + ends)) * 1e3
    warm = float(np.median(dt[DNERF_VIEWS[0][1]:]))  # after the first epoch
    train_s = ends[-1] - t0
    first, last = float(losses[:50].mean()), float(losses[-50:].mean())
    psnr = trainer.last_eval_results["PSNR"]
    occ = trainer.occupancy
    live = int((occ.density_grid.reshape(occ.density_grid.shape[0], -1) > 0).any(-1).sum())
    grid_gib = occ.density_grid.numel() * 4 / 2**30
    meshes = {t: glob.glob(os.path.join(ws, "meshes", f"dnerf_*_t{t}.obj")) for t in ("0.00", "1.00")}
    faces = {t: _faces(p[0]) if p else 0 for t, p in meshes.items()}
    ckpt = CheckpointManager(os.path.join(ws, "checkpoints")).latest_step()
    print(f"[dnerf] main_dnerf -O --dnerf_variant deform --iters {DNERF_ITERS} --time_slots {DNERF_SLOTS} "
          f"{' '.join(DNERF_FLAGS)}: {steps} "
          f"steps of {opt.num_rays} rays in {train_s:.2f} s ({wall:.2f} s with loading, the val eval and the "
          f"meshes): warm median {warm:.2f} ms/step (host clock between step ends, after the first epoch), mean "
          f"{train_s / steps * 1e3:.2f}; peak memory {peak:.3f} GiB; {clocks.summary()} ({smi})")
    print(f"[dnerf] loss first 50 steps {first:.5f}, last 50 {last:.5f}; val PSNR {psnr:.3f} dB ({DNERF_VIEWS[1][1]} "
          f"views), SSIM {trainer.last_eval_results['SSIM']:.4f}; time grid {tuple(occ.density_grid.shape)} "
          f"({grid_gib:.3f} GiB), iter_density {int(occ.iter_density)}, {live} of {occ.density_grid.shape[0]} slots "
          f"non-zero, mean density {float(occ.mean_density):.4f}; skip-walk iterations per step mean "
          f"{np.mean(trainer.march_iters):.1f}; launches {launches}; meshes t=0 {faces['0.00']} faces, t=1 "
          f"{faces['1.00']} faces; checkpoint step {ckpt}")
    if launches["hashgrid_table_grad"] != steps or launches["composite_rays_fused_backward"] != steps:
        raise AssertionError(f"D-NeRF backward kernels launched {launches}, want once per step ({steps})")
    if launches["composite_rays_fused"] < steps:
        raise AssertionError(f"D-NeRF composite forward launched {launches} times in {steps} steps")
    if launches["march_rays_skip"] < steps:  # once a step, and once a chunk of the eval's views
        raise AssertionError(f"D-NeRF's skip walk launched {launches['march_rays_skip']} times in {steps} steps")
    check_encodes("D-NeRF deform training", launches, steps, position=steps)  # the warp: a position gradient a step
    if steps != DNERF_ITERS or not np.isfinite(losses).all() or not last < 0.5 * first:
        raise AssertionError(f"D-NeRF training did not learn: {steps} steps, loss {first} -> {last}")
    if not psnr >= DNERF_PSNR:
        raise AssertionError(f"D-NeRF val PSNR {psnr} dB after {steps} steps, want >= {DNERF_PSNR}")
    if not (int(occ.iter_density) > 0 and live > 1):
        raise AssertionError(f"the time grid was not refreshed: iter_density {int(occ.iter_density)}, {live} slots")
    if not (all(meshes.values()) and ckpt == DNERF_ITERS):
        raise AssertionError(f"D-NeRF outputs: meshes {meshes}, checkpoint step {ckpt}")

    reset_counts()
    t0 = time.time()
    main_dnerf.main([scene, "--test", "-O", "--workspace", ws, "--time_slots", str(DNERF_SLOTS)], device=dev)
    torch.cuda.synchronize()
    serve_s = time.time() - t0
    served = read_counts()
    n_test = DNERF_VIEWS[2][1]
    results = os.path.join(ws, "results")
    renders = [os.path.join(results, f"dnerf_{v:04d}.png") for v in range(n_test)]
    video = os.path.join(results, "dnerf.mp4")
    want = n_test * math.ceil(DNERF_RES * DNERF_RES / CHUNK)
    print(f"[dnerf] main_dnerf --test -O from the checkpoint: {n_test} views across time in {serve_s:.2f} s "
          f"({serve_s / n_test:.3f} s/view), launches {served}; video "
          f"{'dnerf.mp4 ' + str(os.path.getsize(video)) + ' B' if os.path.exists(video) else 'as PNG frames'}")
    if not all(os.path.exists(p) for p in renders) or served["composite_rays_fused"] != want:
        raise AssertionError(f"D-NeRF --test: renders {renders}, launches {served}, want {want} composites")
    check_encodes("D-NeRF --test", served, want)
    profiled_steps(trainer, DNeRFDataset(opt.dataset_options(), split="train", device=dev), 3, "dnerf-profile")
    return launches, trainer


def phase_dnerf_variants(work: str, dev, smi: str):
    """``basis`` and ``hyper`` under ``-O`` and ``deform`` without ``-O``
    (uniform, 512 samples a ray), each for a few tens of steps at full
    width on [dnerf]'s scene, through main_dnerf's trainer: ms/step (host,
    synchronized), peak memory, launches; the loss must be finite and its
    last 10 steps under its first 10. The ``-O`` runs use [dnerf]'s
    DNERF_SLOTS time slots, each refreshed once before the first step (a
    fresh grid is empty in every slot but the first for 16 steps a slot,
    longer than these runs)."""
    import numpy as np
    import torch

    from focnerf_tpu_torch.apps import main_dnerf
    from focnerf_tpu_torch.config import parse_options
    from focnerf_tpu_torch.data.dnerf_provider import DNeRFDataset

    scene = os.path.join(work, "dnerf_scene")
    for name, flags in (("basis", ["-O", "--basis"]), ("hyper", ["-O", "--hyper"]), ("uniform", [])):
        iters = DNERF_VARIANT_ITERS[name]
        opt = parse_options([scene, "--workspace", os.path.join(work, f"dnerf_{name}"), "--iters", str(iters),
                             "--time_slots", str(DNERF_SLOTS)] + flags)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainer = main_dnerf.build_trainer(opt, opt.dnerf_config(), dev)
        ds = DNeRFDataset(opt.dataset_options(), split="train", device=dev)
        if trainer.occupancy is not None:  # every slot refreshed once, as after 16 steps a slot
            for slot in range(trainer.time_slots):
                trainer.global_step = slot * trainer.update_extra_interval
                trainer._maybe_update_occupancy()
            trainer.global_step = 0
        torch.cuda.synchronize()
        reset_counts()
        ms, losses = [], []
        for _ in range(iters):
            t0 = time.perf_counter()
            losses.append(float(trainer.train_step_once(ds)["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
        grid = "" if trainer.occupancy is None else f", time grid {tuple(trainer.occupancy.density_grid.shape)}"
        samples = f"{opt.num_steps} samples a ray" if trainer.occupancy is None else f"slab {opt.train_slab}"
        print(f"[dnerf-variants] {opt.dnerf_variant} {'-O' if opt.cuda_ray else '(no -O)'}, {samples}: {iters} steps, "
              f"median {np.median(ms[5:]):.2f} ms/step (synchronized; step 1 {ms[0]:.1f} ms), peak memory "
              f"{peak:.3f} GiB{grid}; loss first 10 {first:.5f}, last 10 {last:.5f}; launches {launches} ({smi})")
        if not (np.isfinite(losses).all() and last < first):
            raise AssertionError(f"dnerf {name}: loss {first} -> {last}")
        if launches["composite_rays_fused_backward"] != iters or launches["hashgrid_table_grad"] != iters:
            raise AssertionError(f"dnerf {name}: launches {launches}, want each backward once a step")
        # deform and hyper learn through the encode's position gradient; basis encodes fixed points
        check_encodes(f"dnerf {name}", launches, iters, position=0 if opt.dnerf_variant == "basis" else iters)
        del trainer, ds


DNERF_REF_LOSS, DNERF_REF_GRAD = 1e-4, 1e-2  # card fp32 step against the CPU's (phase 6's limits)
# the largest share of a reference batch's rays that may be left out of the
# card-against-CPU step for a point on a cell face, a ReLU that went the other
# way or an early exit at the threshold (dnerf_step_card_vs_cpu)
DNERF_REF_EXCLUDED = 0.1


def encode_cells_differ(a, b, spec):
    """Bool [...] over encode inputs a, b [..., D] in [0, 1] (CPU): True where
    the two put a point in another cell at some level, or one inside [0, 1]^D
    and the other outside. At a cell face the encode's position gradient
    jumps by (corner difference) x (level scale, 4095 at the finest level),
    and at the cube's faces its value jumps to 0; so two fp32 runs whose
    warped points differ in the last bit can differ there by the jump."""
    import torch

    from focnerf_tpu_torch.ops.hashgrid import _level_scale

    def oob(x):
        return ((x < 0.0) | (x > 1.0)).any(-1)

    differ = oob(a) != oob(b)
    for lvl in range(spec.num_levels):
        scale = _level_scale(spec, lvl)  # the encode's own arithmetic: x * scale + 0.5, floored
        differ |= (torch.floor(a * scale + 0.5) != torch.floor(b * scale + 0.5)).any(-1)
    return differ


def near_early_exit(sigmas, deltas, density_scale: float, T_thresh: float, band: float = 1e-3):
    """Bool [N] over a composite's inputs sigmas, deltas [N, T] (CPU): True
    where some sample's transmittance in, exp(-optical depth before it),
    lies within ``band`` (in optical depth, fp64) of T_thresh, where the
    composite keeps or drops the sample (``composite_weights``). The two
    devices' optical depths there differ by ~1e-5; the band is 100 times
    that."""
    import math

    import torch

    if T_thresh <= 0.0:
        return torch.zeros(sigmas.shape[0], dtype=torch.bool)
    s = deltas.double() * density_scale * sigmas.double()
    before = torch.cumsum(s, -1) - s
    return ((before - math.log(1.0 / T_thresh)).abs() < band).any(-1)


def dnerf_reference_batch(seed: int, t: float, n: int = 512):
    """A batch of n rays from one random camera (radius CAMERA_RADIUS) aimed
    near the centre, with random RGBA pixels, at time t (CPU tensors)."""
    import numpy as np
    import torch

    from focnerf_tpu_torch.core.camera import rand_poses

    rng = np.random.default_rng(seed)
    pose = rand_poses(rng, 1, radius=CAMERA_RADIUS)[0]
    d = rng.normal(size=(n, 3)).astype(np.float32) * 0.15 + pose[:3, 2]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return pose, {
        "rays_o": torch.from_numpy(np.broadcast_to(pose[:3, 3], d.shape).astype(np.float32).copy()),
        "rays_d": torch.from_numpy(d.astype(np.float32)),
        "pixels": torch.from_numpy(rng.uniform(0, 1, (n, 4)).astype(np.float32)),
        "time": torch.tensor(t),
    }


def dnerf_march_cases(trainer, dev) -> list:
    """``march_cases``' form for D-NeRF's time grid: the trained field's
    skip field of the slots at t = 0.25 and 0.75, 4096 jittered rays at the
    training slab, as the D-NeRF step marches."""
    import torch

    from focnerf_tpu_torch.core.geometry import near_far_from_aabb
    from focnerf_tpu_torch.render.renderer import default_aabb

    cases = []
    for seed, t in ((21, 0.25), (22, 0.75)):
        _, b = dnerf_reference_batch(seed, t, n=CHUNK)
        b = {k: v.to(dev) for k, v in b.items()}
        skip = trainer._occ_bits_for_batch(b)
        o, d = b["rays_o"], b["rays_d"]
        near, far = near_far_from_aabb(o, d, default_aabb(trainer.cfg, dev), trainer.min_near)
        noise = torch.rand(CHUNK, generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
        cases.append((f"D-NeRF time grid, t = {t} (slot {int(b['time'] * trainer.time_slots)} of "
                      f"{trainer.time_slots}), jittered", (o, d, near, far, skip),
                      dict(bound=trainer.cfg.bound, dt_gamma=trainer.dt_gamma, max_steps=trainer.max_steps,
                           slab=trainer.train_slab, noise=noise), False))
    return cases


def phase_march_dnerf(trainer, dev) -> float:
    """``[kernel-march]`` on D-NeRF's time grid (``dnerf_march_cases``): the
    kernel against the plain walk. Returns the largest |ts| difference (0:
    equal)."""
    return max(march_check(tag, *args, **kw)["err"] for tag, args, kw, _ in dnerf_march_cases(trainer, dev))


def dnerf_step_card_vs_cpu(params0, cfg, batch, draws, kw, skip=None, unmasked=False) -> dict:
    """One D-NeRF train step's loss and gradients, fp32, on the card (kernels)
    and on the CPU (plain versions), from the same params, batch, draws and
    skip field: ``dnerf_loss``'s render and loss (``kw["num_steps"]``: the
    uniform step; else the skip walk of ``dnerf_loss_occupancy``) with one
    backward a device. The fp32 sums of the two differ in their last bits,
    and four piecewise functions turn that into a jump of the gradient:
    the encode at a cell face (``encode_cells_differ``), a ReLU of any net
    at 0, the march's sample count, and the composite's early exit where a
    sample's transmittance meets T_thresh (``near_early_exit``). So between
    the forwards and the backwards, the rays on which the two runs took
    another piece anywhere are taken out of the loss on both devices, and
    both differentiate the same smooth function; their count is returned
    and held to DNERF_REF_EXCLUDED by the caller. Returns the loss and
    gradient errors (rel L2 per leaf, the worst of a key's leaves), the
    smallest of the CPU's largest |gradient| over the net's leaves, the
    card's launches and, with ``unmasked``, the errors of the full loss as
    well (a second backward)."""
    import torch

    from focnerf_tpu_torch.models import dnerf as dnerf_model
    from focnerf_tpu_torch.render import dnerf_renderer
    from focnerf_tpu_torch.render.dnerf_renderer import render_rays_dnerf, render_rays_dnerf_occupancy
    from focnerf_tpu_torch.train.dnerf_steps import DEFORM_REG, _gt_and_bg, _loss
    from focnerf_tpu_torch.train.state import clone_params

    fwd, real_encode, real_mlp = {}, dnerf_model.hashgrid_encode, dnerf_model.mlp_apply
    real_composite = dnerf_renderer.composite_rays_fused
    reset_counts()
    for where in ("cuda", "cpu"):
        to = lambda x: x.to(where)  # noqa: E731
        params = clone_params({k: [to(w) for w in v] if isinstance(v, list) else to(v) for k, v in params0.items()},
                              requires_grad=True)
        tb, td = {k: to(v) for k, v in batch.items()}, {k: to(v) for k, v in draws.items()}
        gt, bg = _gt_and_bg(tb["pixels"], td["bg"])
        inputs, relus, composites = [], [], []

        def recording(table, x01, spec, u=None):
            inputs.append(x01.detach().cpu())
            return real_encode(table, x01, spec, u)

        def recording_mlp(ws, x, compute_dtype=torch.bfloat16):
            with torch.no_grad():  # each hidden layer's input to its ReLU: the first i + 1 layers, same ops
                for i in range(len(ws) - 1):
                    relus.append((real_mlp(ws[: i + 1], x, compute_dtype) > 0).cpu())
            return real_mlp(ws, x, compute_dtype)

        def recording_composite(sigmas, rgbs, deltas, ts, **ckw):
            composites.append(near_early_exit(sigmas.detach().cpu(), deltas.detach().cpu(),
                                              ckw.get("density_scale", 1.0), ckw.get("T_thresh", 0.0)))
            return real_composite(sigmas, rgbs, deltas, ts, **ckw)

        dnerf_model.hashgrid_encode, dnerf_model.mlp_apply = recording, recording_mlp
        dnerf_renderer.composite_rays_fused = recording_composite
        try:
            if "num_steps" in kw:
                out = render_rays_dnerf(params, cfg, tb["rays_o"], tb["rays_d"], tb["time"],
                                        num_steps=kw["num_steps"], perturb=True, z_noise=td["z_noise"], bg_color=bg)
            else:
                out = render_rays_dnerf_occupancy(params, cfg, tb["rays_o"], tb["rays_d"], tb["time"], None,
                                                  perturb=True, noise=td["noise"], bg_color=bg, occ_skip=to(skip),
                                                  **kw)
        finally:
            dnerf_model.hashgrid_encode, dnerf_model.mlp_apply = real_encode, real_mlp
            dnerf_renderer.composite_rays_fused = real_composite
        fwd[where] = (params, out, gt, inputs[0], relus, composites[0])

    (_, og, _, xg, rg, eg), (_, oc, _, xc, rc, ec) = fwd["cuda"], fwd["cpu"]
    n = xc.shape[0]
    cells = encode_cells_differ(xg, xc, cfg.field_spec).reshape(n, -1).any(-1)
    # every net's rows are the samples' (as the encode's) but the basis
    # variant's coefficient net, one row for all: a flip there leaves out every ray
    relu = torch.zeros(n, dtype=torch.bool)
    for a, b in zip(rg, rc):
        relu |= (a != b).reshape(n, -1).any(-1) if a.shape[:-1] == xc.shape[:-1] else bool((a != b).any())
    exits = eg | ec
    counts = og["n_samples"].cpu() != oc["n_samples"] if "n_samples" in oc else torch.zeros(n, dtype=torch.bool)
    bad = cells | relu | exits | counts
    keep = ~bad
    res = {"rays": n, "excluded": int(bad.sum()), "cells": int(cells.sum()), "relus": int(relu.sum()),
           "exits": int(exits.sum()), "counts": int(counts.sum()),
           "points_differ": int((xg != xc).any(-1).sum()), "points": int(xc[..., 0].numel())}
    grads = {}
    for where, (params, out, gt, *_) in fwd.items():
        per_ray = ((out["image"] - gt) ** 2).mean(-1)
        masked = per_ray[keep.to(where)].mean()
        if "deform_mean" in out:
            masked = masked + DEFORM_REG * out["deform_mean"]
        leaves = [(k, w) for k, v in params.items() for w in (v if isinstance(v, list) else [v])]
        losses = {"masked": masked, "full": _loss(out, gt)[0]} if unmasked else {"masked": masked}
        for i, (name, loss) in enumerate(losses.items()):
            g = torch.autograd.grad(loss, [w for _, w in leaves], retain_graph=i + 1 < len(losses))
            grads[where, name] = (float(loss.detach()), [(k, gw.cpu()) for (k, _), gw in zip(leaves, g)])
        if where == "cuda":
            torch.cuda.synchronize()
            res["launches"] = read_counts()
    for name in ("masked", "full") if unmasked else ("masked",):
        (lg, gg), (lc, gc) = grads["cuda", name], grads["cpu", name]
        rel = {}
        for (k, a), (_, b) in zip(gg, gc):
            rel[k] = max(rel.get(k, 0.0), float((a - b).norm() / b.norm().clamp(min=1e-30)))
        res[name] = {"loss": (lg, lc), "loss_rel": abs(lg - lc) / abs(lc), "grad_rel": rel}
        if name == "masked":
            net = next(k for k in rel if k in ("deform_net", "basis_net", "hyper_net"))
            res["net"] = net
            res["net_grad_min_max"] = min(float(b.abs().max()) for k, b in gc if k == net)
    return res


def phase_dnerf_reference(trainer, dev):
    """One train step of each D-NeRF variant on the card (kernels) and on
    the CPU (plain versions), same params, batch, occupancy and draws, fp32
    (``dnerf_step_card_vs_cpu``): deform (the trained params) on the time
    slot's skip walk and on 128 uniform samples, basis and hyper (seeded
    params) on the same skip walk; the loss and every parameter's gradient,
    the deformation and hyper nets' through the position gradient (limits
    DNERF_REF_LOSS and DNERF_REF_GRAD, rel L2 per leaf), over the rays whose
    points lie in the same encode cells on both (at most DNERF_REF_EXCLUDED
    of them left out). Then one 64x64 view at t = 0.5 through the slot's
    bitfield (ladder march), card against CPU."""
    import dataclasses

    import numpy as np
    import torch

    from focnerf_tpu_torch.models.dnerf import init_dnerf_params
    from focnerf_tpu_torch.render.dnerf_renderer import render_image_dnerf, time_occupancy_bitfield
    from focnerf_tpu_torch.train.dnerf_steps import dnerf_step_draws

    t = 0.4
    cfg32 = dataclasses.replace(trainer.cfg, compute_dtype=torch.float32)
    n = 512
    pose, batch = dnerf_reference_batch(9, t, n)
    skip = trainer._occ_bits_for_batch({"time": torch.tensor(t, device=dev)}).cpu()
    occ_kw = dict(dt_gamma=trainer.dt_gamma, max_steps=trainer.max_steps, slab=64)
    trained = {k: [w.detach().cpu() for w in v] if isinstance(v, list) else v.detach().cpu()
               for k, v in trainer.state.params.items()}
    cases = {"deform -O step (trained)": (cfg32, trained, occ_kw),
             "deform uniform step, 128 samples (trained)": (cfg32, trained, dict(num_steps=128))}
    for variant in ("basis", "hyper"):
        # seeded, with the coarse half of the levels widened from U(-1e-4,
        # 1e-4) to U(-0.1, 0.1): at the initial scale the nets' gradients are
        # sums of terms near the rounding level of the features. The fine
        # levels stay faint, as in tests/test_torch_dnerf.py: with U(-0.1,
        # 0.1) there (scale up to 4095 in five dimensions), the 1-ulp
        # differences of the lifted coordinates move hyper_net's gradient by
        # 1.1e-2 rel L2 between card and CPU on an H100
        vcfg = dataclasses.replace(cfg32, variant=variant)
        seeded = init_dnerf_params(torch.Generator().manual_seed(1), vcfg, "cpu")
        seeded["grid"][: vcfg.field_spec.offsets[8]] *= 1e3
        cases[f"{variant} -O step (seeded, levels 0-7 U(-0.1, 0.1))"] = (vcfg, seeded, occ_kw)
    for label, (cfg, params0, kw) in cases.items():
        want = dict(composite_rays_fused=1, composite_rays_resume=0, composite_rays_fused_backward=1,
                    hashgrid_table_grad=1, march_rays_skip=0 if "num_steps" in kw else 1, hashgrid_encode_forward=1,
                    hashgrid_input_grad=0 if cfg.variant == "basis" else 1)
        draws = dnerf_step_draws(torch.Generator().manual_seed(3), n, "cpu", num_steps=kw.get("num_steps", 0))
        r = dnerf_step_card_vs_cpu(params0, cfg, batch, draws, kw, skip)
        m = r["masked"]
        print(f"[dnerf-reference] train step: {label}, {n} rays at t={t}, fp32, card vs CPU: {r['points_differ']} of "
              f"{r['points']} encode inputs differ; {r['excluded']} rays left out (limit {DNERF_REF_EXCLUDED:.0%}): "
              f"{r['cells']} with a point in another cell, {r['relus']} a ReLU the other way, {r['exits']} a sample at "
              f"the early exit, {r['counts']} another march count; loss {m['loss'][0]:.6g} vs {m['loss'][1]:.6g} (rel {m['loss_rel']:.3g}, "
              f"limit {DNERF_REF_LOSS}); gradient rel L2 error per key "
              + ", ".join(f"{k} {v:.3g}" for k, v in m["grad_rel"].items())
              + f" (limit {DNERF_REF_GRAD}); smallest {r['net']} leaf's largest |grad| {r['net_grad_min_max']:.3g}")
        if r["launches"] != want:
            raise AssertionError(f"dnerf reference {label} on the card launched {r['launches']}")
        # sums in other orders, atomics and CUDA vs libm exp/sin: the warped
        # points differ in their last bits, which the finest level (scale
        # 4095 at bound 2) moves its weights by ~2.4e-4
        if not (r["excluded"] <= DNERF_REF_EXCLUDED * r["rays"] and m["loss_rel"] <= DNERF_REF_LOSS
                and max(m["grad_rel"].values()) <= DNERF_REF_GRAD):
            raise AssertionError(f"card and CPU D-NeRF train steps disagree: {label}")
        if not r["net_grad_min_max"] > 0:
            raise AssertionError(f"dnerf reference {label}: {r['net']} got no gradient")

    ema = trainer.state.ema_params
    size = 64
    intr = np.array([1.2 * size, 1.2 * size, size / 2, size / 2], np.float32)
    kw = dict(dt_gamma=trainer.dt_gamma, max_steps=trainer.max_steps, slab=128, max_ray_batch=CHUNK, bg_color=1.0)
    bits = time_occupancy_bitfield(trainer.occupancy, 0.5, trainer.density_thresh)
    reset_counts()
    gi, gd = render_image_dnerf(ema, cfg32, pose, intr, size, size, 0.5, occ_bits=bits, **kw)
    card = read_counts()["composite_rays_fused"]
    ci, cd = render_image_dnerf({k: [w.cpu() for w in v] if isinstance(v, list) else v.cpu() for k, v in ema.items()},
                                cfg32, pose, intr, size, size, 0.5, occ_bits=bits.cpu(), **kw)
    err, derr = (gi.cpu() - ci).abs(), (gd.cpu() - cd).abs()
    print(f"[dnerf-reference] {size}x{size} view at t=0.5 through the slot's bitfield (ladder), card vs CPU: image "
          f"mean abs {float(err.mean()):.3g} (limit 1e-4), max {float(err.max()):.3g}; depth mean abs "
          f"{float(derr.mean()):.3g}; object share {float((ci.min(-1).values < 0.9).float().mean()):.3f}; composite "
          f"launches on the card {card}")
    if not (float(err.mean()) <= 1e-4 and float(derr.mean()) <= 1e-4 and card == 1):
        raise AssertionError("card and CPU D-NeRF views disagree")
    if not float((ci.min(-1).values < 0.9).float().mean()) > 0.01:
        raise AssertionError("the D-NeRF reference view shows no object")


def phase_dnerf_kernel(dev):
    """The table gradient on the hyper field's 5-D layout (16 levels x 32
    corners, J = 512 columns a point) of 4096 x 128 points (the rays'
    points with two lifted coordinates), held against ``table_grad_plain``
    (limit 1e-5 of the largest row sum) and timed beside the plain version
    and ``index_add_`` alone; with its byte bound."""
    import torch

    from focnerf_tpu_torch.config import parse_options
    from focnerf_tpu_torch.ops import hashgrid as thg
    from focnerf_tpu_torch.utils.measure import device_ms

    cfg = parse_options(["scene", "-O", "--hyper"]).dnerf_config()
    spec = cfg.field_spec
    g = torch.Generator(device="cuda").manual_seed(4)
    x = ray_points01(cfg, 128, g)
    x = torch.cat([x, torch.sigmoid(torch.randn((x.shape[0], cfg.hyper_dim), generator=g, device=dev))], -1)
    table = torch.zeros((spec.table_rows, spec.level_dim), device=dev)
    _, rows, weights = thg.hashgrid_encode_forward(table, x, spec, None, residuals=True)
    del table
    cot = torch.randn((x.shape[0], spec.output_dim), generator=g, device=dev)
    cols, n_rows, C = thg.col_levels(spec, False), spec.table_rows, spec.level_dim
    m, J = rows.shape
    col_level = torch.tensor(cols, dtype=torch.int32, device=dev)
    got = thg.hashgrid_table_grad(rows, weights, cot, cols, n_rows)
    want = thg.table_grad_plain(rows, weights, cot, col_level, n_rows, C)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    rel = float((got - want).abs().max()) / scale
    zeros_agree = torch.equal(got == 0, want == 0)
    touched = int((want != 0).any(-1).sum())
    del got, want
    contrib = (weights[..., None] * cot.reshape(m, -1, C).index_select(1, col_level)).reshape(-1, C)
    flat_rows = rows.reshape(-1)
    with SMClocks() as clocks:
        ms, span = device_ms(lambda: thg.hashgrid_table_grad(rows, weights, cot, cols, n_rows), iters=10)
        plain_ms, _ = device_ms(lambda: thg.table_grad_plain(rows, weights, cot, col_level, n_rows, C), iters=10)
        lib_ms, _ = device_ms(lambda: torch.zeros((n_rows, C), device=dev).index_add_(0, flat_rows, contrib), iters=10)
    nbytes = m * J * 8 + cot.numel() * 4 + n_rows * C * 4 + J * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = m * J * C * 2 / FP32_OPS_PER_S * 1e3
    print(f"[kernel-dnerf] hashgrid_table_grad on the hyper field's 5-D layout [{m} points x {J} columns (16 levels x "
          f"32 corners) -> {n_rows} x {C}]: max_abs_err {rel * scale:.3g}, {rel:.3g} of max|d_table| {scale:.3g} "
          f"(limit 1e-5); {touched} rows touched; device {ms:.5f} ms (call span {span:.4f} ms, zero fill included), "
          f"plain {plain_ms:.5f} ms, index_add_ alone {lib_ms:.5f} ms, bound {max(bytes_ms, ops_ms):.5f} ms "
          f"({'bytes' if bytes_ms >= ops_ms else 'operations'}, {nbytes} B); {clocks.summary()}")
    if not (rel <= 1e-5 and zeros_agree):
        raise AssertionError(f"table-gradient kernel disagrees with index_add_ on the 5-D layout: {rel}")


# ------------------------------------------------------------------ phases 20-22
VIEW_RES = 400  # the in-process viewer frames
VIEWER_STARTUP_S, VIEWER_RENDERS = 60, 16  # the entry point's /status wait; renders to see spp go 1 -> 2
VIEWER_BURSTS = 2  # train-while-viewing: 16-step bursts
NO_PRELOAD_ITERS = 100
LPIPS_REL = 1e-4  # the npz LPIPS on the card against the CPU


def free_port() -> int:
    """A port no process listens on now: bind port 0 on 127.0.0.1, read, close."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(port: int, path: str, obj=None, timeout: float = 60.0) -> bytes:
    """GET ``path`` (``obj`` None) or POST ``obj`` as JSON to the viewer on 127.0.0.1."""
    import urllib.request

    data = None if obj is None else json.dumps(obj).encode()
    with urllib.request.urlopen(urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data),
                                timeout=timeout) as r:
        return r.read()


def check_frame(img, shape, what: str):
    """A served frame: finite, ``shape``, not one flat colour."""
    import numpy as np

    img = np.asarray(img, np.float32)
    if img.shape != tuple(shape) or not np.isfinite(img).all() or float(img.std()) < 1e-3:
        raise AssertionError(f"{what}: frame of shape {img.shape} (want {tuple(shape)}), finite "
                             f"{bool(np.isfinite(img).all())}, std {float(img.std()):.4g}")


def sphere_gt(pose, spheres, res: int):
    """The analytic spheres seen from ``pose`` (focal 1.2 * res) on white, [res, res, 3] float32 in [0, 1]."""
    import numpy as np

    rgba = sphere_view(pose, 1.2 * res, spheres, res=res).astype(np.float32) / 255.0
    return rgba[..., :3] * rgba[..., 3:] + (1.0 - rgba[..., 3:])


def frame_psnr(img, gt) -> float:
    import numpy as np

    return float(-10.0 * np.log10(max(float(np.mean((np.clip(img, 0, 1) - gt) ** 2)), 1e-20)))


def check_time_order(frames, gts):
    """Each D-NeRF frame (t = 0, 1) is nearer its own time's analytic
    spheres than the other time's: the slider reaches the field the right
    way round."""
    for i in (0, 1):
        own, other = frame_psnr(frames[i], gts[i]), frame_psnr(frames[i], gts[1 - i])
        if not own > other:
            raise AssertionError(f"[viewer] the D-NeRF frame at t = {i}: {own:.2f} dB against its own time's "
                                 f"spheres, {other:.2f} against the other's")


def phase_viewer_entry_point(scene: str, ws: str):
    """``python -m focnerf_tpu_torch.apps.viewer_app <scene> --workspace <ws>
    --test -O`` in a process of its own on a free port: /status within
    VIEWER_STARTUP_S, the page, /render until spp goes 1 -> 2 on the same
    camera and size, /control bg 0 resets it (and again 1 -> 2); every PNG
    decoded by data/png.py to the size /status names, not one flat colour;
    then the process is terminated and must have exited."""
    import numpy as np

    from focnerf_tpu_torch.config import Options
    from focnerf_tpu_torch.data.png import decode_png

    port = free_port()
    env = dict(os.environ, VIEWER_PORT=str(port))
    env["PYTHONPATH"] = HERE + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    argv = [sys.executable, "-m", "focnerf_tpu_torch.apps.viewer_app", scene, "--workspace", ws, "--test", "-O"]
    t0 = time.time()
    proc = subprocess.Popen(argv, cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        status = None
        while time.time() - t0 < VIEWER_STARTUP_S and proc.poll() is None:
            try:
                status = json.loads(_http(port, "/status", timeout=5))
                break
            except OSError:
                time.sleep(0.25)
        if status is None:
            raise AssertionError(f"viewer_app: no /status within {VIEWER_STARTUP_S} s (exit code {proc.poll()})")
        up_s = time.time() - t0
        if b"<canvas" not in _http(port, "/"):
            raise AssertionError("viewer_app: the page has no canvas")
        cam = {"theta": 0.7, "phi": 0.3, "radius": COMPOSE_RADIUS}
        W0, H0 = Options().W // 2, Options().H // 2  # the entry point's ViewerState
        seen, prev_ds = [], 4  # a ViewerState starts at downscale 4

        def render_until_spp_two(tag: str):
            """POST /render with ``cam`` until spp reads 1 and then 2 (the
            dynamic resolution may move the size first, which resets it);
            the first render of ``tag`` must read spp 1."""
            nonlocal prev_ds
            for k in range(VIEWER_RENDERS):
                t1 = time.perf_counter()
                png = _http(port, "/render", cam)
                ms = (time.perf_counter() - t1) * 1e3
                st = json.loads(_http(port, "/status"))
                img = decode_png(png)
                want = (max(H0 // prev_ds, H0 // 4), max(W0 // prev_ds, W0 // 4), 3)
                seen.append((tag, st["spp"], prev_ds, img.shape[:2], round(ms, 1)))
                prev_ds = st["downscale"]
                check_frame(img.astype(np.float32) / 255.0, want, f"viewer_app {tag} frame {k}")
                if k == 0 and st["spp"] != 1:
                    raise AssertionError(f"viewer_app {tag}: the first render read spp {st['spp']}, want 1")
                if k > 0 and (seen[-2][1], st["spp"]) == (1, 2):
                    return img
            raise AssertionError(f"viewer_app {tag}: spp never went 1 -> 2 in {VIEWER_RENDERS} renders: {seen}")

        white = render_until_spp_two("bg 1")
        out = json.loads(_http(port, "/control", {"bg": 0}))
        if out.get("bg") != 0:
            raise AssertionError(f"viewer_app /control answered {out}")
        black = render_until_spp_two("bg 0")  # its first render: spp reset to 1
        if white.shape == black.shape and not black.astype(int).sum() < white.astype(int).sum():
            raise AssertionError("viewer_app: bg 0 did not darken the frame")
    finally:
        proc.terminate()
        try:
            log, _ = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate(timeout=30)
    if proc.returncode is None:
        raise AssertionError("viewer_app did not exit")
    if f"localhost:{port}" not in log:
        raise AssertionError(f"viewer_app did not print its port {port}: {log[-2000:]}")
    print(f"[viewer] entry point: viewer_app --test -O on port {port}, /status after {up_s:.1f} s; renders "
          f"(settings, spp after, downscale used, PNG size, ms) {seen}; exit code {proc.returncode} after terminate")


def phase_viewer(work: str, dev, smi: str):
    """Phase 20: the viewer. The entry point in a process of its own
    (``phase_viewer_entry_point``) over phase 5's checkpoint; in process,
    one VIEW_RES^2 frame through ``_view_only`` of each workspace kind the
    earlier phases trained (phase 5's hash checkpoint; the same baked at
    128^3, then from its cache; phase 14's dense voxel volume and K-planes
    field at t = 0 and 0.5; phase 17's D-NeRF checkpoint at t = 0 and 1),
    each with its s/frame and, where the scene is analytic, its PSNR
    against the analytic spheres; the hash and D-NeRF frames must launch the
    composite forward once per 4096-ray chunk; then train-while-viewing
    (``_train_while_viewing`` behind a ViewerState and a server on
    127.0.0.1) on phase 5's scene in a fresh workspace: VIEWER_BURSTS bursts
    of 16 steps with renders between them, at least one of them between two
    steps of one burst, every loss finite, each backward
    kernel once a step, save_ckpt through /action, no step after the pause.
    Returns the train-while-viewing run's launches."""
    import threading
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch

    from focnerf_tpu_torch.apps import main_dnerf, viewer_app
    from focnerf_tpu_torch.config import parse_options
    from focnerf_tpu_torch.core.camera import rand_poses
    from focnerf_tpu_torch.data.dnerf_provider import DNeRFDataset
    from focnerf_tpu_torch.data.png import decode_png
    from focnerf_tpu_torch.data.provider import DatasetOptions, NeRFDataset
    from focnerf_tpu_torch.render import renderer as renderer_mod
    from focnerf_tpu_torch.train.checkpoints import CheckpointManager, load_model_config
    from focnerf_tpu_torch.train.trainer import Trainer
    from focnerf_tpu_torch.viewer.server import ViewerState, make_handler

    scene, ws = os.path.join(work, "train_scene"), os.path.join(work, f"train_ws_{OBJECT}")
    phase_viewer_entry_point(scene, ws)

    res, chunks = VIEW_RES, math.ceil(VIEW_RES * VIEW_RES / CHUNK)
    intr = (1.2 * res, 1.2 * res, res / 2, res / 2)
    # every eye outside the bound box [-2, 2]^3, as shear-warp needs (COMPOSE_RADIUS)
    pose = rand_poses(np.random.default_rng(21), 1, radius=COMPOSE_RADIUS)[0]

    def frame(tag, render_fn, t=0.0, p=pose, k=intr, want_launches=None, gt=None, floor=15.0):
        reset_counts()
        t0 = time.perf_counter()
        img = render_fn(p, k, res, res, t)
        s = time.perf_counter() - t0
        launches = read_counts()
        check_frame(img, (res, res, 3), f"[viewer] {tag}")
        psnr = "" if gt is None else f", PSNR {frame_psnr(img, gt):.2f} dB against the analytic spheres"
        warm = "" if "again" in tag else " (its first call: warm-up included)"
        print(f"[viewer] {tag}: {res}x{res} frame in {s:.3f} s{warm}{psnr}; launches {launches} ({smi})")
        if want_launches is not None and launches["composite_rays_fused"] != want_launches:
            raise AssertionError(f"[viewer] {tag}: composite launched {launches}, want {want_launches}")
        if gt is not None and floor is not None and not frame_psnr(img, gt) >= floor:
            raise AssertionError(f"[viewer] {tag}: PSNR {frame_psnr(img, gt):.2f} dB against the analytic spheres")
        return img

    gt = sphere_gt(pose, (SPHERE,), res)
    view = lambda argv: viewer_app._view_only(parse_options(argv), dev)[0]  # noqa: E731
    hash_fn = view([scene, "--workspace", ws, "--test", "-O"])
    frame("hash checkpoint (phase 5, -O)", hash_fn, want_launches=chunks, gt=gt)
    frame("hash checkpoint, again", hash_fn, want_launches=chunks, gt=gt)
    baked = [scene, "--workspace", ws, "--test", "-O", "--baked", "--bake_res", "128"]
    t0 = time.perf_counter()
    fresh = view(baked)
    print(f"[viewer] --baked --bake_res 128: bake, gate and cache in {time.perf_counter() - t0:.2f} s")
    with open(os.path.join(ws, "bake_quality.json")) as f:
        rep = json.load(f)
    a = frame("--baked 128^3 (fresh bake)", fresh, gt=gt)
    t0 = time.perf_counter()
    cached = view(baked)
    print(f"[viewer] --baked --bake_res 128 from the cache: loaded in {time.perf_counter() - t0:.2f} s; gate "
          f"{rep['psnr_baked_vs_exact_mean']} dB mean baked against exact")
    b = frame("--baked 128^3 (cache)", cached, gt=gt)
    frame("--baked 128^3 (cache), again", cached, gt=gt)
    if not float(np.abs(a - b).mean()) <= 2e-3:
        raise AssertionError(f"[viewer] the cached volume's frame is {float(np.abs(a - b).mean())} off the fresh one")
    frame(f"dense voxel {VOXEL_RES}^3 (phase 14)", view([scene, "--workspace", os.path.join(work, "voxel_dense"),
                                                         "--test", "--baked", "--bake_res", str(VOXEL_RES)]), gt=gt)
    dyn = NeRFDataset(DatasetOptions(path=os.path.join(work, f"harddyn_{DYN_RES}_{DYN_GT_RES}"), scale=1.0),
                      split="val", device=dev)
    kp_pose, kp_intr = dyn.poses[0], dyn.intrinsics * (res / dyn.W)
    kp_fn = view([scene, "--workspace", os.path.join(work, "voxel_voxel_kplanes"), "--test", "--baked",
                  "--bake_res", str(VM_RES)])
    kp = []
    for t in (0.0, 0.5):
        reset_counts()
        t0 = time.perf_counter()
        kp.append(kp_fn(kp_pose, kp_intr, res, res, t))
        print(f"[viewer] K-planes 8 at {VM_RES}^3 (phase 14) t = {t}: {res}x{res} frame in "
              f"{time.perf_counter() - t0:.3f} s; launches {read_counts()}")
        check_frame(kp[-1], (res, res, 3), f"[viewer] K-planes t = {t}")
    if not float(np.abs(kp[0] - kp[1]).max()) > 0.02:
        raise AssertionError(f"[viewer] K-planes frames at t = 0 and 0.5 differ by {np.abs(kp[0] - kp[1]).max()}")
    # D-NeRF from its test split's first camera (t = 0), the same render as
    # main_dnerf --test's of that view
    dn_opt = parse_options([os.path.join(work, "dnerf_scene"), "--workspace", os.path.join(work, "dnerf_ws"),
                            "--test", "-O", "--time_slots", str(DNERF_SLOTS)])
    dds = DNeRFDataset(dn_opt.dataset_options(), split="test", device=dev)
    dn_view = dds.eval_view(0)
    dn_pose, dn_intr = dn_view["pose"], dds.intrinsics
    dn_fn = viewer_app._view_only(dn_opt, dev)[0]
    dn, gts = [], [sphere_gt(dn_pose, (dnerf_sphere(t),), res) for t in (0.0, 1.0)]
    for t, g in zip((0.0, 1.0), gts):
        dn.append(frame(f"D-NeRF deform (phase 17) t = {t}", dn_fn, t=t, p=dn_pose, k=dn_intr, want_launches=chunks,
                        gt=g, floor=None))
    trainer = main_dnerf.build_trainer(dn_opt, load_model_config(os.path.join(dn_opt.workspace, "checkpoints")), dev,
                                       use_checkpoint="latest")
    with torch.no_grad():
        ref, _ = trainer._render_view(trainer.state.ema_params, dn_view, dds, trainer._render_kwargs())
    err = float(np.abs(ref.float().cpu().numpy() - dn[0]).max())
    print(f"[viewer] the D-NeRF frame at t = {float(dn_view['time'])} against main_dnerf --test's render of that "
          f"view: max abs difference {err:.3g} (limit 1e-6)")
    if float(dn_view["time"]) != 0.0 or not err <= 1e-6:
        raise AssertionError(f"[viewer] the viewer's D-NeRF frame is {err} off main_dnerf --test's")
    del trainer
    check_time_order(dn, gts)

    # train-while-viewing, at the full width of main_nerf -O, in a fresh workspace
    wsv = os.path.join(work, "viewer_train_ws")
    opt = parse_options([scene, "--workspace", wsv, "-O"])
    steps, losses, inside, at_render, want = [], [], [], [], 16 * VIEWER_BURSTS

    def counted_render(*a, **k):  # inside the lock: the steps done before this render
        at_render.append(len(inside))
        return real_render(*a, **k)

    t0 = time.perf_counter()
    real_render, renderer_mod.render_image = renderer_mod.render_image, counted_render
    try:  # _train_while_viewing's render_fn binds render_image when it is built
        render_fn, train_fn, actions = viewer_app._train_while_viewing(opt, dev)
    finally:
        renderer_mod.render_image = real_render
    setup_s = time.perf_counter() - t0

    def step():
        t1 = time.perf_counter()
        losses.append(train_fn())
        steps.append(time.perf_counter() - t1)
        if len(losses) == want:
            state.paused = True  # takes effect when this burst ends
        return losses[-1]

    real_step = Trainer._train_step

    def timed(self, ds):  # the step alone, inside the lock (synchronized by its loss read)
        t1 = time.perf_counter()
        out = real_step(self, ds)
        float(out[1]["loss"])
        inside.append(time.perf_counter() - t1)
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    Trainer._train_step = timed
    state = ViewerState(render_fn, W=opt.W // 2, H=opt.H // 2, train_fn=step, max_spp=opt.max_spp, actions=actions)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    port, renders, render_ms = srv.server_address[1], 0, []
    try:
        deadline = time.time() + 300
        while len(losses) < want and time.time() < deadline:
            if not state._thread.is_alive():
                raise AssertionError("[viewer] the burst thread died")
            t1 = time.perf_counter()
            decode_png(_http(port, "/render", {"theta": 0.4, "phi": 0.2, "radius": CAMERA_RADIUS}))
            render_ms.append((time.perf_counter() - t1) * 1e3)
            if 0 < len(losses) < want:
                renders += 1
        if len(losses) != want:
            raise AssertionError(f"[viewer] {len(losses)} train steps in 300 s, want {want}")
        saved = json.loads(_http(port, "/action", {"name": "save_ckpt"}))["result"]
        time.sleep(1.0)
        after = len(losses)
        launches = read_counts()
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(30)
        joined = state.stop(timeout=60)
        Trainer._train_step = real_step
    peak = torch.cuda.max_memory_allocated() / 2**30
    ckpt = CheckpointManager(os.path.join(f"{wsv}_{OBJECT}", "checkpoints")).latest_step()
    ms, alone = np.asarray(steps[1:]) * 1e3, np.asarray(inside[1:]) * 1e3
    in_burst = [k for k in at_render if 0 < k < want and k % 16]  # between steps k and k + 1 of one burst
    print(f"[viewer] train-while-viewing (main_nerf -O width, {opt.num_rays} rays a step): set-up {setup_s:.1f} s; "
          f"{len(losses)} steps in {VIEWER_BURSTS} bursts, median {np.median(ms):.2f} ms/step with the wait for the "
          f"lock, {np.median(alone):.2f} inside it (host clock, after the first step), {renders} renders between "
          f"them, {len(in_burst)} of them inside a burst (steps done when each render drew: {at_render}); "
          f"{len(render_ms)} /render calls, the first {render_ms[0]:.1f} ms (its warm-up), median of the rest "
          f"{np.median(render_ms[1:]):.1f} ms (the wait for the lock included); loss first {losses[0]:.5f}, "
          f"last {losses[-1]:.5f}; peak "
          f"memory {peak:.3f} GiB; launches {launches}; save_ckpt: {saved!r}, checkpoint step {ckpt}; steps after "
          f"the pause {after - want}; threads joined {joined and not th.is_alive()} ({smi})")
    if not np.isfinite(losses).all():
        raise AssertionError(f"[viewer] non-finite loss while viewing: {losses}")
    if launches["hashgrid_table_grad"] != want or launches["composite_rays_fused_backward"] != want:
        raise AssertionError(f"[viewer] backward kernels launched {launches}, want once per step ({want})")
    check_encodes("[viewer] train-while-viewing", launches, want + renders)
    if renders < 2 or not in_burst or launches["composite_rays_fused"] <= want:
        raise AssertionError(f"[viewer] {renders} renders between the steps, {len(in_burst)} inside a burst, "
                             f"launches {launches}")
    if ckpt != want or "checkpoint saved" not in saved:
        raise AssertionError(f"[viewer] save_ckpt answered {saved!r}, latest checkpoint {ckpt}")
    if after != want or not joined or th.is_alive():
        raise AssertionError(f"[viewer] {after - want} steps after the pause; threads joined {joined}")
    return launches


def lpips_weights_npz(path: str, seed: int = 0):
    """A random-weight LPIPS npz in the contract's shapes (train/lpips_npz.py)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shapes = [(64, 3, 11, 11), (192, 64, 5, 5), (384, 192, 3, 3), (256, 384, 3, 3), (256, 256, 3, 3)]
    arrs = {}
    for i, shape in enumerate(shapes):
        arrs[f"conv{i}_w"] = rng.normal(0, 0.05, shape).astype(np.float32)
        arrs[f"conv{i}_b"] = rng.normal(0, 0.05, shape[0]).astype(np.float32)
        arrs[f"lin{i}"] = np.abs(rng.normal(0, 0.05, (1, shape[0], 1, 1))).astype(np.float32)
    np.savez(path, **arrs)


def phase_lpips(work: str, dev, smi: str):
    """Phase 21: with a random-weight npz in ``FOCNERF_LPIPS_NPZ``, a Trainer
    on phase 5's checkpoint evaluates the val view of phase 6b's scene (phase
    5's first) and must report ``LPIPS (alex, torch)``; ``lpips_distance``
    on the card must equal the CPU's within LPIPS_REL relative on one view
    pair."""
    import numpy as np
    import torch

    from focnerf_tpu_torch.config import parse_options
    from focnerf_tpu_torch.train import lpips_npz
    from focnerf_tpu_torch.train.trainer import Trainer

    path = os.path.join(work, "lpips_alex.npz")
    lpips_weights_npz(path)
    scene = os.path.join(work, "train_scene")
    opt = parse_options([scene, "-O"])
    os.environ["FOCNERF_LPIPS_NPZ"] = path
    try:
        trainer = Trainer("ngp", opt.nerf_config(), workspace=os.path.join(work, f"train_ws_{OBJECT}"),
                          use_checkpoint="latest", use_occupancy=True, eval_renderer="iter", device=dev)
        val = train_dataset(os.path.join(work, "uniform_scene"), dev, "val")
        t0 = time.perf_counter()
        results = trainer.evaluate(val, save_images=False)
        eval_s = time.perf_counter() - t0
    finally:
        del os.environ["FOCNERF_LPIPS_NPZ"]
    name = "LPIPS (alex, torch)"
    print(f"[lpips] Trainer.evaluate of phase 5's checkpoint on {val.n_views} val views in {eval_s:.2f} s: {results}")
    if name not in results or not (np.isfinite(results[name]) and results[name] > 0):
        raise AssertionError(f"[lpips] evaluate reported {results}, want a positive finite {name!r}")

    view = val.eval_view(0)
    gt = view["pixels"].float().reshape(val.H, val.W, -1)
    gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:])
    img, _ = trainer._render_view(trainer.state.ema_params, view, val, trainer._render_kwargs())
    pred = torch.clamp(img.float(), 0.0, 1.0)
    w = lpips_npz.load_weights(path)
    wd = {k: v.to(dev) for k, v in w.items()}
    lpips_npz.lpips_distance(wd, pred, gt)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = float(lpips_npz.lpips_distance(wd, pred, gt))
    card_ms = (time.perf_counter() - t0) * 1e3
    cpu = float(lpips_npz.lpips_distance(w, pred.cpu(), gt.cpu()))
    rel = abs(card - cpu) / abs(cpu)
    print(f"[lpips] lpips_distance on a {val.H}x{val.W} view pair: card {card:.7f} ({card_ms:.2f} ms), CPU "
          f"{cpu:.7f}, relative difference {rel:.2e} (limit {LPIPS_REL}) ({smi})")
    if not rel <= LPIPS_REL:
        raise AssertionError(f"[lpips] card {card} against CPU {cpu}: {rel:.3g} relative")


def pixel_indices(batch, pose, intr):
    """The pixel index of each ray of ``batch``, recovered from its direction
    (the inverse of core.rays.get_rays for a pinhole camera)."""
    import numpy as np

    d = batch["rays_d"].double().cpu().numpy() @ np.asarray(pose, np.float64)[:3, :3]
    fx, fy, cx, cy = (float(v) for v in intr)
    return d[:, 0] / d[:, 2] * fx + cx - 0.5, d[:, 1] / d[:, 2] * fy + cy - 0.5


def phase_no_preload(work: str, dev, smi: str, pre):
    """Phase 22: ``main_nerf <phase 6b scene> --no-preload --cuda_ray --iters
    NO_PRELOAD_ITERS`` at full width (no -O: it forces preload; the scene is
    phase 5's with one val view to evaluate): the native
    library must build (its path printed) and the train split stay on the
    host; on the run's first 3 batches the pixels must equal the preloaded
    image at the pixels their rays leave through within 1/255; the loss of
    the last 10 steps must be under the first 10's; each backward kernel once
    a step. Then the trained model steps on host and preloaded batches in
    turns (host, preloaded, preloaded, host; 16 steps each, one occupancy
    update in each) for ms/step. ``pre`` is phase 5's train split, preloaded
    as ``main_nerf -O`` loads it (the same images).
    Returns the run's launches."""
    import numpy as np
    import torch

    from focnerf_tpu_torch.apps import main_nerf
    from focnerf_tpu_torch.apps.main_nerf import mask_details_for
    from focnerf_tpu_torch.config import parse_options
    from focnerf_tpu_torch.data import native_loader
    from focnerf_tpu_torch.data.provider import NeRFDataset
    from focnerf_tpu_torch.data.yolo_sidecar import load_sidecar
    from focnerf_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    built = native_loader.available()
    print(f"[no-preload] native loader library: {native_loader.library_note()} ({time.perf_counter() - t0:.2f} s)")
    if not built:
        raise AssertionError("[no-preload] the native loader did not build")
    scene, ws = os.path.join(work, "uniform_scene"), os.path.join(work, "nopreload_ws")
    argv = [scene, "--no-preload", "--cuda_ray", "--workspace", ws, "--iters", str(NO_PRELOAD_ITERS),
            "--disable_yolo", "--mesh_res", "0"]
    captured, ends = [], []
    real_batch, real_step = NeRFDataset._host_train_batch, Trainer._train_step

    def host_batch(self):
        batch = real_batch(self)
        if len(captured) < 3:
            captured.append({k: v.clone() for k, v in batch.items()})
        return batch

    def timed(self, ds):  # the host clock at the end of every train step
        out = real_step(self, ds)
        ends.append(time.perf_counter())
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    NeRFDataset._host_train_batch, Trainer._train_step = host_batch, timed
    t0 = time.perf_counter()
    try:
        (trainer,) = main_nerf.main(argv, device=dev)
        torch.cuda.synchronize()
    finally:
        NeRFDataset._host_train_batch, Trainer._train_step = real_batch, real_step
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = np.asarray(trainer.step_losses)
    dt = np.diff(np.asarray(ends)) * 1e3
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    print(f"[no-preload] main_nerf --no-preload --cuda_ray --iters {NO_PRELOAD_ITERS}: {len(losses)} steps of "
          f"{trainer.cfg.grid_spec.table_rows} table rows x {trainer.cfg.level_dim}, median {np.median(dt[9:]):.2f} "
          f"ms/step (host clock between step ends, after the first 10), mean {np.mean(dt):.2f}; {wall:.2f} s with "
          f"loading and the val eval; peak memory {peak:.3f} GiB; loss first 10 {first:.5f}, last 10 {last:.5f}; "
          f"val PSNR {trainer.last_eval_results['PSNR']:.3f} dB; launches {launches} ({smi})")
    if len(captured) != 3 or len(losses) != NO_PRELOAD_ITERS:
        raise AssertionError(f"[no-preload] {len(captured)} host batches seen, {len(losses)} steps")
    if launches["hashgrid_table_grad"] != len(losses) or launches["composite_rays_fused_backward"] != len(losses):
        raise AssertionError(f"[no-preload] backward kernels launched {launches}, want once per step")
    if launches["composite_rays_fused"] < len(losses):
        raise AssertionError(f"[no-preload] composite forward launched {launches} in {len(losses)} steps")
    check_encodes("[no-preload]", launches, len(losses))
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError(f"[no-preload] loss {first} -> {last}")

    details = mask_details_for(load_sidecar(scene, "train"), OBJECT)
    worst = 0.0
    for b in captured:
        v = int(b["view"])
        x, y = pixel_indices(b, pre.poses[v], pre.intrinsics)
        if not (np.abs(x - np.round(x)).max() < 1e-2 and np.abs(y - np.round(y)).max() < 1e-2):
            raise AssertionError("[no-preload] a ray does not leave through a pixel centre")
        inds = torch.as_tensor(np.round(y).astype(np.int64) * pre.W + np.round(x).astype(np.int64), device=dev)
        want_px = pre.images[v][inds].float()  # fp16 under -O: within 2^-11 of the uint8 value / 255
        worst = max(worst, float((b["pixels"].float() - want_px).abs().max()))
        if not torch.equal(b["ray_mask"], pre.masks_dev[v][inds]):
            raise AssertionError("[no-preload] a host batch's mask is not the image's")
    print(f"[no-preload] 3 host batches against the preloaded images at the pixels their rays leave through: "
          f"max abs difference {worst:.3g} (limit 1/255)")
    if not worst <= 1 / 255 + 1e-6:
        raise AssertionError(f"[no-preload] host pixels {worst} off the image")

    host = NeRFDataset(parse_options([scene, "--no-preload"]).dataset_options(), split="train",
                       mask_details=details, device=dev)
    if host.images_host is None:
        raise AssertionError("[no-preload] the host pipeline preloaded the train split")
    ms = {"host": [], "preloaded": []}
    try:
        for name, ds in (("host", host), ("preloaded", pre), ("preloaded", pre), ("host", host)):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(16):  # one occupancy update in every window
                trainer.train_step_once(ds)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t1) * 1e3 / 16)
    finally:
        host.close()
    print(f"[no-preload] the trained model, 16 synchronized steps a window in turns (host, preloaded, preloaded, "
          f"host): host batches {[round(m, 2) for m in ms['host']]} ms/step, preloaded "
          f"{[round(m, 2) for m in ms['preloaded']]} ms/step ({smi})")
    return launches


CLIP_ITERS, CLIP_RAND_POSE = 20, 3  # [clip]: steps 3, 7, 11, 15, 19 are CLIP steps
CLIP_CLI_VIEWS = 4  # [clip]'s CLI run without weights: one epoch of 4 steps
CLIP_ROTATE = 16  # input copies [clip] times the composite kernels on in turn


class StandInCLIP:
    """A seeded, differentiable stand-in for the CLIP loss (the repository
    holds no CLIP weights): the image [H, W, 3] resized to 224 as the port's
    CLIP loss resizes it, normalized by CLIP's mean and std, pooled to 4 x 4,
    projected by a fixed [48, 64] matrix and scored 1 - cos against a fixed
    text vector."""

    def __init__(self, device, seed: int = 0):
        import torch

        g = torch.Generator().manual_seed(seed)
        self.proj = torch.randn(3 * 4 * 4, 64, generator=g).to(device)
        text = torch.randn(64, generator=g)
        self.text = (text / text.norm()).to(device)
        self.mean = torch.tensor([0.48145466, 0.4578275, 0.40821073], device=device).reshape(3, 1, 1)
        self.std = torch.tensor([0.26862954, 0.26130258, 0.27577711], device=device).reshape(3, 1, 1)

    def __call__(self, image):
        import torch.nn.functional as F

        from focnerf_tpu_torch.train.clip_guidance import CLIP_SIZE, resize_bilinear

        x = (resize_bilinear(image.permute(2, 0, 1)[None]) - self.mean) / self.std
        emb = F.avg_pool2d(x, CLIP_SIZE // 4).reshape(1, -1) @ self.proj
        return 1.0 - (emb / emb.norm() * self.text).sum()


def clip_cli_scene(work: str) -> str:
    """The first CLIP_CLI_VIEWS train views of phase 5's scene (the images
    linked), with no YOLO sidecar and no val split."""
    src, scene = os.path.join(work, "train_scene"), os.path.join(work, "clip_cli_scene")
    os.makedirs(scene)
    os.symlink(os.path.join(src, "train"), os.path.join(scene, "train"))
    with open(os.path.join(src, "transforms_train.json")) as f:
        tj = json.load(f)
    tj["frames"] = tj["frames"][:CLIP_CLI_VIEWS]
    with open(os.path.join(scene, "transforms_train.json"), "w") as f:
        json.dump(tj, f)
    return scene


def phase_clip(work: str, dev, smi: str, ds):
    """The CLIP rand-pose branch at full width (``[clip]``): (a) a ``main_nerf
    -O --n_chunks 0 --rand_pose CLIP_RAND_POSE`` trainer on phase 5's scene
    (``ds``, its train split as ``main_nerf -O`` loads it) with the seeded
    stand-in loss trains CLIP_ITERS steps (finite losses,
    the CLIP steps where the schedule puts them, each backward kernel once a
    step); one CLIP step on the card against the CPU from the same weights,
    rays and draws in fp32 (loss 1e-4 relative, every gradient 1e-2 rel L2,
    the table's and the nets' nonzero); ms per CLIP step; the composite
    forward and backward and the table gradient held against their plain
    versions at the step's shapes and timed; (b) and (c) ``main_nerf
    --rand_pose 0 --clip_text`` on a scene without a sidecar and without
    ``--disable_yolo``: with neither transformers' weights nor ultralytics
    on this machine it writes the background-only sidecar, says once that no
    CLIP loss is available and trains on. Returns the launches of (a)."""
    import contextlib
    import dataclasses
    import io
    import itertools

    import numpy as np
    import torch

    from focnerf_tpu_torch.apps import main_nerf
    from focnerf_tpu_torch.config import parse_options
    from focnerf_tpu_torch.data.yolo_sidecar import load_sidecar, yolo_available
    from focnerf_tpu_torch.ops import hashgrid as thg
    from focnerf_tpu_torch.ops.composite import (
        composite_rays,
        composite_rays_fused,
        composite_rays_fused_backward,
        group_width,
    )
    from focnerf_tpu_torch.train.state import clone_params, param_leaves
    from focnerf_tpu_torch.train.steps import clip_step_draws, clip_step_loss
    from focnerf_tpu_torch.train.trainer import Trainer
    from focnerf_tpu_torch.utils.measure import counted_device_ms

    # (a) the stand-in CLIP branch through the trainer
    scene, ws = os.path.join(work, "train_scene"), os.path.join(work, "clip_ws")
    opt = parse_options([scene, "-O", "--n_chunks", "0", "--rand_pose", str(CLIP_RAND_POSE), "--iters",
                         str(CLIP_ITERS), "--ckpt", "scratch"])
    trainer = Trainer("ngp", opt.nerf_config(), workspace=ws, device=dev, clip_loss_fn=StandInCLIP(dev),
                      **main_nerf.trainer_options(opt))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    trainer.train(ds, None, max_epochs=1, steps_per_epoch=CLIP_ITERS)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    want_clip = [s for s in range(CLIP_ITERS) if s % (CLIP_RAND_POSE + 1) == CLIP_RAND_POSE]
    losses = np.asarray(trainer.step_losses)
    batch = ds.rand_pose_batch(np.random.default_rng(11))
    n, H, W, T = batch["rays_o"].shape[0], batch["H"], batch["W"], min(trainer.num_steps, 128)
    print(f"[clip] main_nerf -O --n_chunks 0 --rand_pose {CLIP_RAND_POSE}, stand-in loss: {CLIP_ITERS} steps in "
          f"{wall:.2f} s, CLIP steps {trainer.clip_steps} ({H}x{W} = {n} rays x {T} samples each), losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}, peak memory {peak:.3f} GiB, launches {launches}")
    if trainer.clip_steps != want_clip or len(losses) != CLIP_ITERS or not np.isfinite(losses).all():
        raise AssertionError(f"[clip] schedule {trainer.clip_steps} (want {want_clip}) or losses {losses}")
    if launches["hashgrid_table_grad"] != CLIP_ITERS or launches["composite_rays_fused_backward"] != CLIP_ITERS \
            or launches["composite_rays_fused"] < CLIP_ITERS:
        raise AssertionError(f"[clip] launches {launches}, want each backward kernel once a step ({CLIP_ITERS})")
    check_encodes("[clip]", launches, CLIP_ITERS)

    # one CLIP step, card against CPU, fp32, from the trained weights
    cfg32 = dataclasses.replace(trainer.cfg, compute_dtype=torch.float32)
    draws = clip_step_draws(torch.Generator().manual_seed(5), cfg32, n, T, "cpu")
    out, seconds = {}, {}
    for where in ("cuda", "cpu"):
        to = lambda t: t.to(where)  # noqa: E731
        params = clone_params({k: [to(w) for w in v] if isinstance(v, list) else to(v)
                               for k, v in trainer.state.params.items()}, requires_grad=True)
        reset_counts()
        t0 = time.time()
        loss = clip_step_loss(params, cfg32, to(batch["rays_o"]), to(batch["rays_d"]),
                              {k: to(v) for k, v in draws.items()}, StandInCLIP(where), H=H, W=W, num_steps=T,
                              min_near=trainer.min_near)
        loss.backward()
        grads = [p.grad.cpu() for p in param_leaves(params)]
        seconds[where] = time.time() - t0
        if where == "cuda" and read_counts() != dict(composite_rays_fused=1, composite_rays_resume=0,
                                                     composite_rays_fused_backward=1, hashgrid_table_grad=1,
                                                     march_rays_skip=0, hashgrid_encode_forward=1,
                                                     hashgrid_input_grad=0):
            raise AssertionError(f"[clip] the reference CLIP step on the card launched {read_counts()}")
        out[where] = (float(loss.detach()), grads)
    (lg, gg), (lc, gc) = out["cuda"], out["cpu"]
    loss_rel = abs(lg - lc) / abs(lc)
    rels = [float((a - b).norm() / b.norm().clamp(min=1e-30)) for a, b in zip(gg, gc)]
    live = [int((g != 0).sum()) for g in gc]
    print(f"[clip] one CLIP step, {n} rays x {T} samples, fp32, card vs CPU ({seconds['cuda']:.2f} s / "
          f"{seconds['cpu']:.2f} s): loss {lg:.6g} vs {lc:.6g} (rel {loss_rel:.3g}, limit 1e-4), gradient rel L2 "
          f"errors {', '.join(f'{r:.3g}' for r in rels)} (limit 1e-2); nonzero entries per leaf {live}")
    if not (loss_rel <= 1e-4 and max(rels) <= 1e-2):
        raise AssertionError("[clip] card and CPU CLIP steps disagree")
    if not all(live):
        raise AssertionError(f"[clip] a leaf got no gradient through the CLIP loss: {live}")

    # ms per CLIP step, the trainer's own step (bf16 MLPs), warm
    step_ms = []
    rng = np.random.default_rng(12)
    for _ in range(4):
        b = ds.rand_pose_batch(rng)
        d = clip_step_draws(trainer.generator, trainer.cfg, n, T, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer._clip_step_fn(trainer.state, b["rays_o"], b["rays_d"], d)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"[clip] CLIP step ms (synchronized, after the run's 5): {', '.join(f'{x:.2f}' for x in step_ms)}; "
          f"median {float(np.median(step_ms)):.2f} ms ({smi})")
    del trainer, params, grads, out

    # the kernels at the CLIP step's shapes: [n, 128] at T_thresh 0 on a
    # white background, and the -O encode's table gradient at n x 128 points
    def clock(fn):  # device ms per call, unless the trace lost events
        ms, got_n, want_n = counted_device_ms(fn)
        if got_n == want_n > 0:
            return f"{ms:.5f} ms"
        return f"not measured ({got_n} of {want_n} device events recorded)"

    sig, rgb, dts, ts, _ = composite_inputs(T, thin=True, n=n)
    ts = ts / ts[:, -1:]
    got = composite_rays_fused(sig, rgb, dts, ts, bg_color=1.0, T_thresh=0.0)
    ref = composite_rays(sig, rgb, dts, ts, bg_color=1.0, T_thresh=0.0)
    g = torch.Generator(device="cuda").manual_seed(1)
    cot = tuple(torch.randn(sh, generator=g, device="cuda") for sh in ((n, 3), (n,), (n,)))

    def kernel_bwd():
        return composite_rays_fused_backward(sig, rgb, dts, ts, 1.0, got, cot, T_thresh=0.0)

    def plain_bwd(s_=sig, c_=rgb, d_=dts, t_=ts, *_):
        s_, c_ = s_.detach().requires_grad_(), c_.detach().requires_grad_()
        o = composite_rays(s_, c_, d_, t_, bg_color=1.0, T_thresh=0.0)
        return torch.autograd.grad((o["image"], o["weights_sum"], o["depth"]), (s_, c_), cot)

    dk, dp = kernel_bwd(), plain_bwd()
    torch.cuda.synchronize()
    if not all(torch.isfinite(a).all() for a in (*got, *dk)):
        raise AssertionError(f"[clip] composite kernels: non-finite output at [{n},{T}]")
    f_err = max(float((a - b).abs().max()) for a, b in zip(got, (ref["image"], ref["weights_sum"], ref["depth"])))
    b_err = max(float((a - b).abs().max()) for a, b in zip(dk, dp))
    # timed on CLIP_ROTATE copies of the inputs in turn (14 MB each, more
    # than 4x the 50 MB L2 together), so every launch reads them from HBM
    # and the times compare with the byte bounds
    pool = [tuple(x.clone() for x in (sig, rgb, dts, ts, *got)) for _ in range(CLIP_ROTATE)]
    turn = itertools.cycle(pool)

    def rotated(fn):
        return lambda: fn(*next(turn))

    ms = clock(rotated(lambda s_, c_, d_, t_, *o: composite_rays_fused(s_, c_, d_, t_, bg_color=1.0, T_thresh=0.0)))
    plain_ms = clock(rotated(lambda s_, c_, d_, t_, *o: composite_rays(s_, c_, d_, t_, bg_color=1.0, T_thresh=0.0)))
    bms = clock(rotated(lambda s_, c_, d_, t_, *o: composite_rays_fused_backward(s_, c_, d_, t_, 1.0, o, cot,
                                                                                 T_thresh=0.0)))
    bplain_ms = clock(rotated(plain_bwd))
    del pool, turn
    # bounds as phase 3's: every sample read at T_thresh 0 (24 B, ~17 fp32
    # operations; the backward 35 and 16 B written a sample), the outputs
    # (20 B a ray; the backward reads them and their cotangents, 52 B)
    read = n * T
    f_bound = max((read * 24 + 12 + n * 20) / HBM_BYTES_PER_S, read * 17 / FP32_OPS_PER_S) * 1e3
    b_bound = max((read * 24 + n * 52 + read * 16) / HBM_BYTES_PER_S, read * 35 / FP32_OPS_PER_S) * 1e3
    print(f"[clip] composite_rays_fused [{n},{T}] T_thresh=0, white background, {group_width(T)} lanes per ray: "
          f"max_abs_err {f_err:.3g} (limit 1e-5), device {ms}, plain {plain_ms}, bound "
          f"{f_bound:.5f} ms (bytes; times over {CLIP_ROTATE} input copies in turn, read from HBM)")
    print(f"[clip] composite_rays_fused_backward [{n},{T}] T_thresh=0: max_abs_err {b_err:.3g} (limit 1e-5), "
          f"device {bms}, plain (forward + autograd) {bplain_ms}, bound {b_bound:.5f} ms (bytes)")
    if not (f_err <= 1e-5 and b_err <= 1e-5):
        raise AssertionError(f"[clip] composite kernels disagree with their plain versions: {f_err} {b_err}")
    del sig, rgb, dts, ts, got, ref, dk, dp

    rows_t, weights, cot, cols, n_rows = table_grad_inputs(opt.nerf_config(), samples=T, n=n)
    m, J = rows_t.shape
    C = opt.nerf_config().level_dim
    col_level = torch.tensor(cols, dtype=torch.int32, device=rows_t.device)
    got = thg.hashgrid_table_grad(rows_t, weights, cot, cols, n_rows)
    want = thg.table_grad_plain(rows_t, weights, cot, col_level, n_rows, C)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    t_err = float((got - want).abs().max())
    if not (t_err <= 1e-5 * scale and torch.equal(got == 0, want == 0)):
        raise AssertionError(f"[clip] table-gradient kernel disagrees with index_add_: {t_err / scale}")
    contrib = (weights[..., None] * cot.reshape(m, -1, C).index_select(1, col_level)).reshape(-1, C)
    flat = rows_t.reshape(-1)
    ms = clock(lambda: thg.hashgrid_table_grad(rows_t, weights, cot, cols, n_rows))
    plain_ms = clock(lambda: thg.table_grad_plain(rows_t, weights, cot, col_level, n_rows, C))
    lib_ms = clock(lambda: torch.zeros((n_rows, C), device=flat.device).index_add_(0, flat, contrib))
    nbytes = m * J * 8 + cot.numel() * 4 + n_rows * C * 4 + J * 4
    bound = max(nbytes / HBM_BYTES_PER_S, m * J * C * 2 / FP32_OPS_PER_S) * 1e3
    print(f"[clip] hashgrid_table_grad -O encode {m} points x {J} columns: max_abs_err {t_err:.3g} "
          f"({t_err / scale:.3g} of max|d_table|, limit 1e-5), device {ms}, plain {plain_ms}, "
          f"index_add_ alone {lib_ms}, bound {bound:.5f} ms ({nbytes} B)")
    del rows_t, weights, cot, got, want, contrib, flat

    # (b) and (c): the CLI on this machine, without CLIP weights or ultralytics
    cli_scene, cli_ws = clip_cli_scene(work), os.path.join(work, "clip_cli_ws")
    argv = [cli_scene, "-O", "--workspace", cli_ws, "--rand_pose", "0", "--clip_text", "a sphere",
            "--iters", str(CLIP_CLI_VIEWS), "--mesh_res", "0", "--ckpt_interval", "10"]
    reset_counts()
    said = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(said):
        (cli,) = main_nerf.main(argv, device=dev)
    torch.cuda.synchronize()
    cli_s, cli_launches, said = time.time() - t0, read_counts(), said.getvalue()
    with open(cli.log_path) as f:
        warned = f.read().count("no CLIP loss available")
    sidecar = load_sidecar(cli_scene, "train")
    print(f"[clip] main_nerf {' '.join(argv[1:])} (no sidecar, no --disable_yolo; ultralytics importable: "
          f"{yolo_available()}): {cli_s:.2f} s, {cli.global_step} steps, losses "
          f"{', '.join(f'{x:.4f}' for x in cli.step_losses)}, warnings {warned}, rand_pose now {cli.rand_pose}, "
          f"sidecar objects {list(sidecar['names'])}, launches {cli_launches}; its lines:")
    for line in said.splitlines():
        if line.startswith(("[yolo]", "[main_nerf]", "[WARN]")):
            print(f"[clip]   {line}")
    if yolo_available() or said.count("ultralytics is not installed") != 1 or list(sidecar["names"]) != ["background"] \
            or not sidecar["background__masks"].all():
        raise AssertionError("[clip] the CLI did not take the missing-ultralytics branch (background-only sidecar)")
    if warned != 1 or cli.rand_pose != -1 or cli.clip_steps or cli.global_step != CLIP_CLI_VIEWS \
            or not np.isfinite(cli.step_losses).all():
        raise AssertionError("[clip] the CLI without CLIP weights did not warn once and train on")
    if cli_launches["hashgrid_table_grad"] != CLIP_CLI_VIEWS:
        raise AssertionError(f"[clip] the CLI run launched {cli_launches}")
    return launches


PARALLEL_RANKS, PARALLEL_STEPS = 2, 10  # [parallel]: gloo ranks on the one card; DP steps of phase 5's batches
PARALLEL_RANK_TIMEOUT = 240  # s each rank subprocess (and the torchrun run) may take
PARALLEL_VIEWS = 8  # train views of the voxel CLI runs (phase 5's first 8; val: its first)
PARALLEL_SP_ITERS, PARALLEL_DPSP_ITERS = 24, 4  # main_voxel --voxel_sp under torchrun; --voxel_sp --voxel_dp 2
PARALLEL_LOSS_REL, PARALLEL_TABLE_REL = 1e-4, 1e-2  # DP against world 1: PERF.md §2's hash gates
PARALLEL_COMPOSE_MEAN = 1e-4  # compose_rays_sharded against compose_rays, mean absolute
PARALLEL_VOXEL_REL = 1e-2  # the SP step against one device: PERF.md §2's bf16 voxel gate
# the collapse-sharded factor steps: VM at the resolution parallel/vm_sp.py
# exists for (tools/vm_sp_bench.py --res 512 --rank 8), K-planes at
# main_voxel's default --bake_res; rank, time slots, the K-planes step's
# time, and the warm steps timed after the checked first one
FACTOR_VM_RES, FACTOR_RANK, FACTOR_TIME_SLOTS, FACTOR_T, FACTOR_TIMED_STEPS = 512, 8, 16, 0.37, 2
FACTOR_LR, FACTOR_TV, FACTOR_TIME_SMOOTH = 2e-2, 1e-4, 1e-3  # the SP steps' defaults, passed to the one-device steps
PARALLEL_KPLANES_ITERS, PARALLEL_KPLANES_C2F = 24, 2  # torchrun main_voxel --voxel_sp --voxel_kplanes 8


def _parallel_draws(cfg, n_rays: int, slab: int, step: int, dev):
    """Step ``step``'s draws of the global batch: the same on every rank
    and in the world-1 run (a seeded generator on the device)."""
    import torch

    from focnerf_tpu_torch.train.steps import step_draws

    return step_draws(torch.Generator(device=dev).manual_seed(1000 + step), cfg, n_rays, slab, dev)


def parallel_scene(work: str) -> str:
    """Phase 5's training scene cut to its first PARALLEL_VIEWS train views
    and first val view (images linked): what the voxel CLI runs of
    [parallel] load on every rank."""
    src, scene = os.path.join(work, "train_scene"), os.path.join(work, "parallel", "scene")
    os.makedirs(scene)
    for split, n in (("train", PARALLEL_VIEWS), ("val", 1)):
        os.symlink(os.path.join(src, split), os.path.join(scene, split))
        with open(os.path.join(src, f"transforms_{split}.json")) as f:
            meta = json.load(f)
        meta["frames"] = meta["frames"][:n]
        with open(os.path.join(scene, f"transforms_{split}.json"), "w") as f:
            json.dump(meta, f)
    return scene


def _table(state):
    return state.params["grid"].detach().clone()


def _params_digest(params) -> str:
    from focnerf_tpu_torch.train.state import param_leaves

    return _leaves_digest(param_leaves(params))


def _leaves_digest(leaves) -> str:
    import hashlib

    h = hashlib.sha256()
    for p in leaves:
        h.update(p.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _factor_problem(name: str, inp, dev):
    """One factor family's step problem, alike in every process: (the
    seeded initial field, its resolution, the view's (axis, flip) and its
    target and mask warped to the intermediate plane)."""
    import torch

    from focnerf_tpu_torch.render import baked as tb
    from focnerf_tpu_torch.train import voxel_kplanes as tkp
    from focnerf_tpu_torch.train import voxel_vm as tvm

    g = torch.Generator().manual_seed(0)
    if name == "vm":
        res, field = FACTOR_VM_RES, tvm.init_vm_field(FACTOR_VM_RES, rank=FACTOR_RANK, generator=g, device=dev)
    else:
        res, field = VOXEL_RES, tkp.init_kplanes_field(VOXEL_RES, rank=FACTOR_RANK, time_res=FACTOR_TIME_SLOTS,
                                                       generator=g, device=dev)
    pose, img, intr = inp["voxel_pose"], inp["voxel_image"], inp["voxel_intr"]
    axis, flip = tb.view_axis(pose.cpu().numpy(), 1.0)
    wgt, mask = tb.warp_gt_to_intermediate(img, pose, intr, 1.0, axis=axis, flip=flip, ri=2 * res)
    return field, res, axis, flip, wgt, mask


def _timed_steps(run, sync):
    """(the first call's value, its ms, the mean ms of FACTOR_TIMED_STEPS
    further calls)."""
    t0 = time.time()
    value = run()
    sync()
    first_ms = (time.time() - t0) * 1e3
    t0 = time.time()
    for _ in range(FACTOR_TIMED_STEPS):
        run()
    sync()
    return value, first_ms, (time.time() - t0) * 1e3 / FACTOR_TIMED_STEPS


def _peak_gib(dev) -> float:
    import torch

    return torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan")


def factor_one_device(name: str, inp, dev, sync) -> dict:
    """The one-device step of a factor family (``make_vm_dp_step`` /
    ``make_kplanes_dp_step`` at world 1, in the caller's group) on
    ``_factor_problem``: its mse, its factors after the first step (on the
    host), ms for the first and the warm steps, peak memory."""
    import torch

    from focnerf_tpu_torch.parallel.mesh import make_mesh
    from focnerf_tpu_torch.train import voxel_kplanes as tkp
    from focnerf_tpu_torch.train import voxel_vm as tvm

    field, res, axis, flip, wgt, mask = _factor_problem(name, inp, dev)
    kw = dict(H=1, W=1, resolution=res, warp_axis=axis, flip=flip, lr=FACTOR_LR, tv_weight=FACTOR_TV)
    pose = inp["voxel_pose"].cpu().numpy()[None]
    if name == "vm":
        init, step = tvm.make_vm_dp_step(make_mesh(device=dev), (1.0,) * 4, **kw)
        args = (pose, wgt[None], mask[None])
    else:
        init, step = tkp.make_kplanes_dp_step(make_mesh(device=dev), (1.0,) * 4,
                                              time_smooth_weight=FACTOR_TIME_SMOOTH, **kw)
        args = (pose, [FACTOR_T], wgt[None], mask[None])
    state = init(field)
    del field
    out = {}
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def run():
        mse = float(step(state, *args))
        if "leaves" not in out:
            out["leaves"] = [p.detach().to("cpu", copy=True) for p in state.leaves]
        return mse

    out["mse"], out["first_ms"], out["warm_ms"] = _timed_steps(run, sync)
    out["peak_gib"] = _peak_gib(dev)
    return out


def factor_sp_rank(name: str, mesh, inp, pdir: str, rank: int, dev, sync) -> dict:
    """One rank's collapse-sharded step of a factor family
    (``make_vm_sp_step`` / ``make_kplanes_sp_step``) on ``_factor_problem``:
    the mse, a digest of the factors after the first step and after the
    timed ones, ms per step, this rank's peak memory; rank 0 also holds its
    first update against the one-device step's (``factor_one.pt``)."""
    import torch

    from focnerf_tpu_torch.parallel.kplanes_sp import make_kplanes_sp_step
    from focnerf_tpu_torch.parallel.vm_sp import make_vm_sp_step

    field, res, axis, flip, wgt, mask = _factor_problem(name, inp, dev)
    kw = dict(resolution=res, warp_axis=axis, flip=flip, lr=FACTOR_LR, tv_weight=FACTOR_TV)
    pose = inp["voxel_pose"]
    if name == "vm":
        init, step = make_vm_sp_step(mesh, **kw)
        args = (pose, wgt, mask)
    else:
        init, step = make_kplanes_sp_step(mesh, time_smooth_weight=FACTOR_TIME_SMOOTH, **kw)
        args = (pose, FACTOR_T, wgt, mask)
    field0 = [p.detach().to("cpu", copy=True) for p in field]
    state = init(field)
    del field
    out = {"axis": axis, "flip": flip, "res": res}
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def run():
        mse = float(step(state, *args))
        if "digest1" not in out:
            out["digest1"] = _leaves_digest(state.leaves)
            if rank == 0:
                one = torch.load(os.path.join(pdir, "factor_one.pt"), weights_only=False)[name]
                d_sp = torch.cat([(p.detach().cpu() - p0).flatten() for p, p0 in zip(state.leaves, field0)])
                d_one = torch.cat([(p - p0).flatten() for p, p0 in zip(one["leaves"], field0)])
                out["update_rel"] = float((d_sp - d_one).norm() / d_one.norm().clamp(min=1e-30))
        return mse

    out["mse"], out["first_ms"], out["warm_ms"] = _timed_steps(run, sync)
    out["peak_gib"] = _peak_gib(dev)
    out["digest"] = _leaves_digest(state.leaves)
    del state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def parallel_rank(rank: int, world: int, pdir: str, device: str = "cuda") -> None:
    """One rank of phase [parallel], in a process of its own on the one card
    (gloo): the -O DP occupancy step PARALLEL_STEPS times on phase 5's global
    batches, compose_rays_sharded (K = 2, one object a rank; rank 0 also
    composes on its own), one slice-parallel dense step at the inputs'
    voxel resolution (rank 0 also takes the single-device step), the
    collapse-sharded VM and K-planes steps (``factor_sp_rank``), then
    ``main_voxel --voxel_sp --voxel_dp 2`` in this group. Writes rank<r>.pt
    for the parent."""
    import torch

    from focnerf_tpu_torch import interop
    from focnerf_tpu_torch.apps import main_voxel
    from focnerf_tpu_torch.parallel.distributed import initialize, shutdown
    from focnerf_tpu_torch.parallel.mesh import make_mesh
    from focnerf_tpu_torch.parallel.sharding import (
        compose_rays_sharded,
        make_sharded_train_step_occupancy,
        shard_objects,
    )
    from focnerf_tpu_torch.parallel.voxel_sp import _gather_field, make_voxel_sp_step
    from focnerf_tpu_torch.render import baked as tb
    from focnerf_tpu_torch.render.compose import compose_rays
    from focnerf_tpu_torch.train import voxel as tvox
    from focnerf_tpu_torch.train.state import TrainState

    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    summary = initialize(rank, world, init_method=f"file://{pdir}/store", timeout_s=PARALLEL_RANK_TIMEOUT,
                         device=dev)
    out = {"backend": summary["backend"]}
    times = {"start": time.time()}
    inp = torch.load(os.path.join(pdir, "inputs.pt"), map_location=dev, weights_only=False)
    cfg = interop.config_from_dict(inp["cfg"])
    times["inputs"] = time.time()
    mesh = make_mesh(device=dev)
    kw, res = inp["step_kw"], inp["voxel_res"]

    # -O data parallel: PARALLEL_STEPS steps of the global batches
    state = TrainState(inp["params"], lr=inp["lr"], iters=inp["iters"])
    step = make_sharded_train_step_occupancy(cfg, mesh, **kw)
    sync()
    reset_counts()
    t0 = time.time()
    losses = []
    for s, batch in enumerate(inp["batches"]):
        m = step(state, batch, inp["occ"], _parallel_draws(cfg, batch["rays_o"].shape[0], kw["slab"], s, dev))
        losses.append(float(m["loss"]))
        if s == 0:
            out["table1"] = _table(state).cpu()
            out["march_iters0"] = m["march_iters"]
    sync()
    out["dp_s"] = time.time() - t0
    times["dp"] = time.time()
    out["dp_launches"] = read_counts()
    out["losses"], out["digest"] = losses, _params_digest(state.params)

    # object-sharded composition, K = 2: phase 5's object and a shifted copy
    objs, feats, offsets = [inp["params"], inp["params"]], inp["compose_feats"], inp["compose_offsets"]
    reset_counts()
    got = compose_rays_sharded(shard_objects(objs, mesh), cfg, inp["rays_o"], inp["rays_d"], mesh, feats, offsets)
    out["compose_launches"] = read_counts()
    if rank == 0:
        want = compose_rays(objs, cfg, inp["rays_o"], inp["rays_d"], feats, offsets)
        out["compose_err"] = {k: float((got[k] - want[k]).abs().mean()) for k in ("image", "depth", "alpha")}
        out["compose_alpha"] = float(want["alpha"].mean())
    times["compose"] = time.time()

    # one slice-parallel dense step at res^3 against one device
    pose, img, intr = inp["voxel_pose"], inp["voxel_image"], inp["voxel_intr"]
    axis, flip = tb.view_axis(pose.cpu().numpy(), 1.0)
    wgt, mask = tb.warp_gt_to_intermediate(img, pose, intr, 1.0, axis=axis, flip=flip, ri=2 * res)
    raw0 = tvox.init_voxel_field(res, generator=torch.Generator().manual_seed(0), device=dev)
    init, sp_step, shard = make_voxel_sp_step(mesh, intr, resolution=res, warp_axis=axis, flip=flip)
    sp = init(shard(raw0))
    sync()
    t0 = time.time()
    sp_mse = float(sp_step(sp, pose, wgt, mask))
    sync()
    out["sp_step_s"] = time.time() - t0
    full = _gather_field(sp.leaves[0], axis, mesh.get_group())
    if rank == 0:
        one = tvox.FieldState(raw0, 5e-2)
        loss_fn = tvox._make_loss(axis, flip, raw_fn=lambda r, t: r, reg_fn=lambda r: 1e-4 * tvox.tv_loss(r),
                                  bound=1.0, sh_degree=0, ri=2 * res, bg_color=1.0, density_scale=1.0,
                                  remat=True, supervise="intermediate")
        loss, mse = loss_fn(one.params, pose, 0.0, wgt, mask)
        loss.backward()
        one.optimizer.step()
        d_sp, d_one = full - raw0, one.leaves[0].detach() - raw0
        out["sp"] = {"mse": sp_mse, "mse_one": float(mse.detach()), "axis": axis, "flip": flip,
                     "update_rel": float((d_sp - d_one).norm() / d_one.norm().clamp(min=1e-30))}
    del full, sp, raw0
    times["sp"] = time.time()

    # the collapse-sharded factor steps, each against its one-device step
    for name in ("vm", "kplanes"):
        out[name] = factor_sp_rank(name, mesh, inp, pdir, rank, dev, sync)
        times[name] = time.time()

    # main_voxel --voxel_sp --voxel_dp 2 in this group (a data x slice = 2 x 1 mesh)
    vol, info = main_voxel.main([inp["scene"], "--workspace", os.path.join(pdir, "dpsp_ws"), "--bake_res",
                                 str(res), "--scale", str(inp["scale"]), "--bound", "1.0", "--iters",
                                 str(PARALLEL_DPSP_ITERS), "--voxel_sp", "--voxel_dp", "2"], device=dev)
    out["dpsp"] = {"mesh": info["mesh"], "step_mse": [float(x) for x in info["step_mse"]],
                   "seconds": info["seconds"], "rgba_digest": _params_digest({"v": vol.rgba})}
    times["dpsp"] = time.time()
    names = list(times)
    out["times"] = {b: round(times[b] - times[a], 2) for a, b in zip(names, names[1:])}
    torch.save(out, os.path.join(pdir, f"rank{rank}.pt"))
    shutdown()


def _start_ranks(pdir: str, world: int, device: str):
    """Start ``world`` parallel_rank processes (output to rank<r>.log)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (HERE, os.environ.get("PYTHONPATH")) if p))
    procs = []
    for r in range(world):
        with open(os.path.join(pdir, f"rank{r}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", f"import chip_smoke; chip_smoke.parallel_rank({r}, {world}, {pdir!r}, "
                                       f"{device!r})"], cwd=HERE, env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs


def _rank_logs(pdir: str, n: int):
    out = []
    for r in range(n):
        with open(os.path.join(pdir, f"rank{r}.log")) as f:
            out.append(f.read())
    return out


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _wait_ranks(pdir: str, procs, deadline: float):
    """Wait until every rank has exited; a rank that fails, or the deadline
    passing, kills them all and fails the phase with their logs."""
    failed = None
    while failed is None:
        codes = [p.poll() for p in procs]
        if any(c not in (None, 0) for c in codes):
            failed = f"rank {next(r for r, c in enumerate(codes) if c not in (None, 0))} exited with an error"
        elif all(c == 0 for c in codes):
            return
        elif time.time() > deadline:
            failed = f"the ranks ran past their {PARALLEL_RANK_TIMEOUT} s"
        else:
            time.sleep(0.2)
    _kill(procs)
    tail = "\n".join(f"--- rank {r}:\n{text[-3000:]}" for r, text in enumerate(_rank_logs(pdir, len(procs))))
    raise AssertionError(f"[parallel] {failed}\n{tail}")


def phase_parallel(work: str, dev, smi: str, trainer, ds) -> dict:
    """The multi-device paths: the world-1 -O DP step and the factor
    families' one-device steps (``factor_one_device``) on NCCL in this
    process, then PARALLEL_RANKS ranks on the one card over gloo
    (``parallel_rank``), then ``torchrun --nproc_per_node 2 -m
    focnerf_tpu_torch.apps.main_voxel --voxel_sp`` at VOXEL_RES^3 and its
    K-planes run (``phase_parallel_kplanes_cli``). Returns the kernels'
    launches summed over the ranks' DP steps and sharded composition."""
    import numpy as np
    import torch

    from focnerf_tpu_torch import interop
    from focnerf_tpu_torch.apps.main_voxel import _rgb_on_white
    from focnerf_tpu_torch.config import parse_options
    from focnerf_tpu_torch.core.rays import get_rays
    from focnerf_tpu_torch.parallel.distributed import initialize, shutdown
    from focnerf_tpu_torch.parallel.mesh import make_mesh
    from focnerf_tpu_torch.parallel.sharding import make_sharded_train_step_occupancy
    from focnerf_tpu_torch.train.state import TrainState, detached

    pdir = os.path.join(work, "parallel")
    shutil.rmtree(pdir, ignore_errors=True)
    scene, scale = parallel_scene(work), parse_options(["x"]).scale
    cfg = trainer.cfg
    kw = dict(dt_gamma=trainer.dt_gamma, max_steps=trainer.max_steps, slab=trainer.active_slab,
              skip_field=trainer.skip_march, min_near=trainer.min_near, color_space=trainer.color_space,
              alpha_weight=trainer.alpha_loss)
    gen = torch.Generator(device=dev).manual_seed(7)
    batches = []
    for _ in range(PARALLEL_STEPS):
        b = ds.train_batch(gen)
        batches.append({k: v for k, v in b.items() if k != "view"})
    n_rays = batches[0]["rays_o"].shape[0]
    view = ds.eval_view(0)
    size = 64
    intr = np.asarray(ds.intrinsics, np.float32) * np.float32(size / ds.W)
    rays = get_rays(view["pose"], intr, size, size, device=dev)
    feat = view["obj_feat"] if "obj_feat" in view else torch.zeros(max(cfg.yolo_feats_dim, 1), device=dev)
    imgs = _rgb_on_white(ds)
    inp = {
        "cfg": interop.config_to_dict(cfg), "params": detached(trainer.state.params),
        "lr": 1e-2, "iters": 30000, "step_kw": kw, "batches": batches,
        "occ": trainer._occ_bits_for_batch(), "rays_o": rays["rays_o"], "rays_d": rays["rays_d"],
        "compose_feats": torch.stack([feat, feat]),
        "compose_offsets": torch.tensor([[0.0, 0.0, 0.0], [0.3, 0.0, 0.0]], device=dev),
        "voxel_pose": torch.as_tensor(ds.poses[0], device=dev), "voxel_image": imgs[0],
        "voxel_intr": torch.as_tensor(np.asarray(ds.intrinsics, np.float32), device=dev),
        "scene": scene, "scale": scale, "voxel_res": VOXEL_RES,
    }
    torch.save(inp, os.path.join(pdir, "inputs.pt"))
    del imgs

    # world size 1 on NCCL in this process: the same step on the whole batch
    summary = initialize(device=dev)
    if summary["num_processes"] != 1 or summary["backend"] != ("nccl" if dev.type == "cuda" else "gloo"):
        raise AssertionError(f"[parallel] world-1 group: {summary}")
    state = TrainState(inp["params"], lr=inp["lr"], iters=inp["iters"])
    grid0 = _table(state)
    m1 = make_sharded_train_step_occupancy(cfg, make_mesh(device=dev), **kw)(
        state, batches[0], inp["occ"], _parallel_draws(cfg, n_rays, kw["slab"], 0, dev))
    loss1, grid1 = float(m1["loss"]), _table(state)
    del state
    # the factor families' one-device steps, which the ranks' SP steps are held to
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    one = {name: factor_one_device(name, inp, dev, sync) for name in ("vm", "kplanes")}
    shutdown()
    torch.save({name: {"leaves": o.pop("leaves"), "mse": o["mse"]} for name, o in one.items()},
               os.path.join(pdir, "factor_one.pt"))
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the ranks and, beside them, torchrun (the two share the card and the
    # host: the DP step's ms/step below is taken beside torchrun's start-up)
    ws = os.path.join(pdir, "sp_ws")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (HERE, os.environ.get("PYTHONPATH")) if p))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(PARALLEL_RANKS),
           "-m", "focnerf_tpu_torch.apps.main_voxel", scene, "--workspace", ws, "--bake_res", str(VOXEL_RES),
           "--scale", str(scale), "--bound", "1.0", "--iters", str(PARALLEL_SP_ITERS), "--voxel_sp"]
    t0 = time.time()
    procs = _start_ranks(pdir, PARALLEL_RANKS, dev.type)
    try:
        with open(os.path.join(pdir, "torchrun.log"), "w") as log:
            cli = subprocess.Popen(cmd, cwd=HERE, env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            _wait_ranks(pdir, procs, t0 + PARALLEL_RANK_TIMEOUT)
            ranks_s = time.time() - t0
            cli.wait(timeout=max(t0 + PARALLEL_RANK_TIMEOUT - time.time(), 1))
        finally:
            _kill([cli])
    finally:
        _kill(procs)
    cli_s = time.time() - t0
    logs = _rank_logs(pdir, PARALLEL_RANKS)
    with open(os.path.join(pdir, "torchrun.log")) as f:
        cli_out = f.read()
    res = [torch.load(os.path.join(pdir, f"rank{r}.pt"), weights_only=False) for r in range(PARALLEL_RANKS)]
    r0 = res[0]
    loss_rel = abs(r0["losses"][0] - loss1) / abs(loss1)
    d_dp, d_one = r0["table1"].to(dev) - grid0, grid1 - grid0
    table_rel = float((d_dp - d_one).norm() / d_one.norm().clamp(min=1e-30))
    launches = {k: sum(r["dp_launches"][k] + r["compose_launches"][k] for r in res) for k in res[0]["dp_launches"]}
    print(f"[parallel] world 1 on {summary['backend']} in this process; {PARALLEL_RANKS} ranks on the one card "
          f"over {r0['backend']} (rank processes {ranks_s:.1f} s in all; rank 0's seconds after its start-up "
          f"{r0['times']})")
    print(f"[parallel] -O DP occupancy step at full width, {n_rays} rays global ({n_rays // PARALLEL_RANKS}"
          f" a rank), slab {kw['slab']}: first loss {r0['losses'][0]:.6g} vs world 1 {loss1:.6g} (rel {loss_rel:.3g}, "
          f"limit {PARALLEL_LOSS_REL}); table update rel L2 {table_rel:.3g} (limit {PARALLEL_TABLE_REL}); "
          f"{PARALLEL_STEPS} steps in {r0['dp_s']:.2f} s ({r0['dp_s'] / PARALLEL_STEPS * 1e3:.1f} ms/step); losses "
          f"{', '.join(f'{x:.4f}' for x in r0['losses'])}; params after {PARALLEL_STEPS} steps equal on every rank: "
          f"{len({r['digest'] for r in res}) == 1}; launches per rank "
          f"{[r['dp_launches'] for r in res]} ({smi})")
    print(f"[parallel] compose_rays_sharded K = 2 ({PARALLEL_RANKS} ranks, one object each) against compose_rays on "
          f"rank 0, {size}x{size} rays x 512 samples: mean abs error {r0['compose_err']} (limit "
          f"{PARALLEL_COMPOSE_MEAN}); mean alpha {r0['compose_alpha']:.3f}; launches per rank "
          f"{[r['compose_launches'] for r in res]}")
    sp = r0["sp"]
    sp_rel = abs(sp["mse"] - sp["mse_one"]) / abs(sp["mse_one"])
    print(f"[parallel] slice-parallel dense step at {VOXEL_RES}^3 (axis {sp['axis']}, flip {sp['flip']}, ri "
          f"{2 * VOXEL_RES}, bf16 operands) on {PARALLEL_RANKS} ranks against one device: mse {sp['mse']:.6g} vs "
          f"{sp['mse_one']:.6g} (rel {sp_rel:.3g}), field update rel L2 {sp['update_rel']:.3g} (limits "
          f"{PARALLEL_VOXEL_REL}); {r0['sp_step_s'] * 1e3:.1f} ms for the step on rank 0")
    dpsp = r0["dpsp"]
    print(f"[parallel] main_voxel --voxel_sp --voxel_dp 2 at {VOXEL_RES}^3: mesh {dpsp['mesh']}, "
          f"{len(dpsp['step_mse'])} steps, mse {', '.join(f'{x:.4f}' for x in dpsp['step_mse'])}, "
          f"{dpsp['seconds']:.2f} s of fit")
    if not (loss_rel <= PARALLEL_LOSS_REL and table_rel <= PARALLEL_TABLE_REL):
        raise AssertionError("[parallel] the DP step disagrees with the world-1 step")
    if len({r["digest"] for r in res}) != 1:
        raise AssertionError("[parallel] the ranks' params differ after the DP steps")
    for name in ("composite_rays_fused", "composite_rays_fused_backward", "hashgrid_table_grad"):
        if not launches[name] > 0:
            raise AssertionError(f"[parallel] {name} was not launched: {launches}")
    check_encodes("[parallel]", launches, 1)
    if not max(r0["compose_err"].values()) <= PARALLEL_COMPOSE_MEAN or not 0.0 < r0["compose_alpha"]:
        raise AssertionError(f"[parallel] sharded composition: {r0['compose_err']}")
    if not (sp_rel <= PARALLEL_VOXEL_REL and sp["update_rel"] <= PARALLEL_VOXEL_REL):
        raise AssertionError("[parallel] the slice-parallel step disagrees with one device")
    if dpsp["mesh"] != {"data": 2, "slice": 1} or not np.isfinite(dpsp["step_mse"]).all() or \
            len({r["dpsp"]["rgba_digest"] for r in res}) != 1:
        raise AssertionError(f"[parallel] main_voxel --voxel_sp --voxel_dp 2: {[r['dpsp'] for r in res]}")
    if "[dpspvoxel] trained on a 2x1 (data x slice) mesh" not in logs[0] or "[dpspvoxel]" in logs[1]:
        raise AssertionError("[parallel] --voxel_dp: rank 0 alone should print [dpspvoxel]")
    for name, label in (("vm", f"VM rank {FACTOR_RANK}"),
                        ("kplanes", f"K-planes rank {FACTOR_RANK}, {FACTOR_TIME_SLOTS} time slots, t {FACTOR_T},")):
        f, o = r0[name], one[name]
        rel = abs(f["mse"] - o["mse"]) / abs(o["mse"])
        same1, same = len({r[name]["digest1"] for r in res}) == 1, len({r[name]["digest"] for r in res}) == 1
        print(f"[parallel] collapse-sharded {label} SP step at {f['res']}^3 (axis {f['axis']}, flip {f['flip']}, ri "
              f"{2 * f['res']}, bf16 operands) on {PARALLEL_RANKS} ranks against one device (make_{name}_dp_step at "
              f"world 1): mse {f['mse']:.6g} vs {o['mse']:.6g} (rel {rel:.3g}), factor update rel L2 "
              f"{f['update_rel']:.3g} (limits {PARALLEL_VOXEL_REL}); factors equal on every rank after 1 step "
              f"{same1}, after {1 + FACTOR_TIMED_STEPS} {same}; SP ms/step first {f['first_ms']:.1f}, warm "
              f"{f['warm_ms']:.1f} (ranks {[round(r[name]['warm_ms'], 1) for r in res]}); one device first "
              f"{o['first_ms']:.1f}, warm {o['warm_ms']:.1f}; peak memory per rank "
              f"{[round(r[name]['peak_gib'], 3) for r in res]} GiB, one device {o['peak_gib']:.3f} GiB ({smi})")
        if not (rel <= PARALLEL_VOXEL_REL and f["update_rel"] <= PARALLEL_VOXEL_REL):
            raise AssertionError(f"[parallel] the collapse-sharded {name} step disagrees with one device")
        if not (same1 and same and np.isfinite(f["mse"])):
            raise AssertionError(f"[parallel] the ranks' {name} factors differ after the SP steps")

    # main_voxel --voxel_sp through torchrun, one process a rank
    if cli.returncode != 0:
        raise AssertionError(f"[parallel] torchrun main_voxel --voxel_sp exited {cli.returncode}:\n{cli_out[-4000:]}")
    import re

    mses = [float(x) for x in re.findall(r"\[spvoxel\] iter \d+/\d+ mse ([0-9.]+)", cli_out)]
    trained = re.findall(r"\[voxel\] \d+ iters in ([0-9.]+)s — train PSNR ([0-9.]+) dB, ([0-9]+) rays/s", cli_out)
    print(f"[parallel] torchrun --nproc_per_node {PARALLEL_RANKS} -m focnerf_tpu_torch.apps.main_voxel --voxel_sp "
          f"--bake_res {VOXEL_RES} --iters {PARALLEL_SP_ITERS}: {cli_s:.1f} s with start-up, loading, saving, mesh "
          f"and val (beside the ranks); logged mse "
          f"{', '.join(f'{x:.4f}' for x in mses)}; fit {trained}; backends "
          f"{sorted(set(re.findall(r'backend (\w+)', cli_out)))} ({smi})")
    for name in (f"baked_{VOXEL_RES}_sh0.npz", "mesh.obj", "log.txt"):
        if not os.path.exists(os.path.join(ws, name)):
            raise AssertionError(f"[parallel] torchrun main_voxel --voxel_sp wrote no {name}")
    with open(os.path.join(ws, "log.txt")) as f:
        lines = f.read().splitlines()
    if cli_out.count(f"[spvoxel] trained sharded over {PARALLEL_RANKS} devices") != 1 or len(lines) != 1:
        raise AssertionError(f"[parallel] torchrun main_voxel --voxel_sp: want one writer, log {lines}")
    # a few dozen steps over the views' variants move the mse by less than
    # the views differ: the first step's agreement with one device (above)
    # is the check of the values, this one of the run
    val = re.findall(r"\[voxel\] val PSNR: ([0-9.]+) dB", cli_out)
    if len(trained) != 1 or len(val) != 1 or not (len(mses) >= 2 and np.isfinite(mses).all()):
        raise AssertionError(f"[parallel] torchrun main_voxel --voxel_sp: mse {mses}, fit {trained}, val {val}")
    phase_parallel_kplanes_cli(work, pdir, env, smi)
    return launches


def phase_parallel_kplanes_cli(work: str, pdir: str, env: dict, smi: str) -> None:
    """``torchrun --nproc_per_node 2 -m focnerf_tpu_torch.apps.main_voxel
    --voxel_sp --voxel_kplanes 8 --voxel_c2f 2`` at VOXEL_RES^3 on phase
    14's dynamic hard scene (its per-frame times), PARALLEL_KPLANES_ITERS
    steps on the ladder through ``fit_kplanes_sp_c2f``: one writer prints
    ``[kplanes] SP over 2 devices``, the planes' npz loads with its shapes,
    every logged step mse is finite and the later half's mean is under the
    earlier half's, and the val PSNR is finite."""
    import re

    import numpy as np

    from focnerf_tpu_torch.train.voxel import _c2f_stage_plan
    from focnerf_tpu_torch.train.voxel_kplanes import load_kplanes_field

    scene, ws = os.path.join(work, f"harddyn_{DYN_RES}_{DYN_GT_RES}"), os.path.join(pdir, "kplanes_ws")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(PARALLEL_RANKS),
           "-m", "focnerf_tpu_torch.apps.main_voxel", scene, "--workspace", ws, "--bake_res", str(VOXEL_RES),
           "--scale", "1.0", "--bound", "1.0", "--iters", str(PARALLEL_KPLANES_ITERS), "--voxel_sp",
           "--voxel_kplanes", str(FACTOR_RANK), "--voxel_c2f", str(PARALLEL_KPLANES_C2F)]
    t0 = time.time()
    with open(os.path.join(pdir, "torchrun_kplanes.log"), "w") as log:
        cli = subprocess.Popen(cmd, cwd=HERE, env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        cli.wait(timeout=PARALLEL_RANK_TIMEOUT)
    except subprocess.TimeoutExpired:
        pass
    finally:
        _kill([cli])
    cli_s = time.time() - t0
    with open(os.path.join(pdir, "torchrun_kplanes.log")) as f:
        out = f.read()
    if cli.returncode != 0:
        raise AssertionError(f"[parallel] torchrun main_voxel --voxel_sp --voxel_kplanes exited {cli.returncode} "
                             f"after {cli_s:.1f} s:\n{out[-4000:]}")
    log_every = max(PARALLEL_KPLANES_ITERS // 10, 1)
    plan = _c2f_stage_plan(VOXEL_RES, PARALLEL_KPLANES_C2F, PARALLEL_KPLANES_ITERS)
    mses = [float(x) for x in re.findall(r"\[spkplanes\] iter \d+/\d+ mse ([0-9.]+)", out)]
    trained = re.findall(r"\[kplanes\] \d+ iters in ([0-9.]+)s — train PSNR ([0-9.]+) dB, ([0-9]+) rays/s", out)
    val = re.findall(r"\[kplanes\] val PSNR: ([0-9.]+) dB", out)
    print(f"[parallel] torchrun --nproc_per_node {PARALLEL_RANKS} -m focnerf_tpu_torch.apps.main_voxel --voxel_sp "
          f"--voxel_kplanes {FACTOR_RANK} --voxel_c2f {PARALLEL_KPLANES_C2F} --bake_res {VOXEL_RES} --iters "
          f"{PARALLEL_KPLANES_ITERS} (ladder {plan}) on harddyn_{DYN_RES}_{DYN_GT_RES}: {cli_s:.1f} s with start-up, "
          f"loading, saving, meshes and val; logged mse {', '.join(f'{x:.4f}' for x in mses)}; fit (s, train PSNR, "
          f"rays/s) {trained}; val PSNR {val} dB ({smi})")
    path = os.path.join(ws, f"kplanes_{VOXEL_RES}_sh0.npz")
    field, bound, sh = load_kplanes_field(path, device="cpu")
    if field.space.shape != (3, VOXEL_RES, VOXEL_RES, FACTOR_RANK, 4) or \
            field.time.shape != (3, VOXEL_RES, FACTOR_TIME_SLOTS, FACTOR_RANK, 4) or (bound, sh) != (1.0, 0):
        raise AssertionError(f"[parallel] {path}: {field.space.shape}, {field.time.shape}, {bound}, {sh}")
    with open(os.path.join(ws, "log.txt")) as f:
        lines = f.read().splitlines()
    if out.count(f"[kplanes] SP over {PARALLEL_RANKS} devices") != 1 or len(lines) != 1:
        raise AssertionError(f"[parallel] torchrun --voxel_kplanes: want one writer, log {lines}")
    # each logged mse is one view's: the later half's mean must be under the earlier half's
    n_logged, half = sum(n // log_every for _, n in plan), len(mses) // 2
    if len(mses) != n_logged or not np.isfinite(mses).all() or not np.mean(mses[half:]) < np.mean(mses[:half]):
        raise AssertionError(f"[parallel] torchrun --voxel_kplanes: logged mse {mses}, want {n_logged} finite, "
                             "falling")
    if len(trained) != 1 or len(val) != 1 or not np.isfinite(float(val[0])):
        raise AssertionError(f"[parallel] torchrun --voxel_kplanes: fit {trained}, val {val}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import focnerf_tpu_torch  # noqa: F401  (fails outside the repository)

    t_start = time.time()

    def phase(name, fn, *args):
        print(f"[phase-start] {name}", flush=True)  # a failure below names its phase
        t0 = time.time()
        out = fn(*args)
        print(f"[phase] {name}: {time.time() - t0:.1f} s")
        return out

    smi = phase("device", phase_device)
    phase("build", phase_build)
    from focnerf_tpu_torch.config import parse_options

    cfg = parse_options(["scene", "-O"]).nerf_config()  # the training path's model
    kernels = phase("kernels", lambda: [*phase_composite_kernel(), phase_composite_backward_kernel(),
                                        phase_table_grad_kernel(cfg)])
    phase("kernels at the uniform and -O2 shapes", phase_uniform_shapes, cfg)
    # before any torch.profiler run with CPU activity: a CUDA-only one
    # after those recorded no device time on the card
    phase("dnerf kernel", phase_dnerf_kernel, torch.device("cuda"))
    work = os.path.join(HERE, "workspace_chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    dev = torch.device("cuda")
    params, cfg, bits, serve_points = phase("serving", phase_serving, work, dev)
    kernels += phase("encode kernel", phase_encode_kernel, serve_points)
    launches, trainer = phase("training", phase_train, work, dev)
    ds = train_dataset(os.path.join(work, "train_scene"), dev)
    val_ds = train_dataset(os.path.join(work, "train_scene"), dev, "val")
    march_entry = phase("march kernel", phase_march_kernel, trainer, ds, val_ds, dev)
    kernels.append(march_entry)
    phase("eval renderers", phase_eval_renderers, trainer, val_ds)
    del val_ds
    phase("train profile", phase_train_profile, trainer, ds, dev)
    phase("backward mask", phase_backward_mask, trainer, ds, dev)
    phase("render reference", phase_reference, params, cfg, bits)
    phase("iterative reference", phase_iterative_reference, trainer)
    phase("train reference", phase_train_reference, trainer, ds)
    fused_launches = phase("fused", phase_fused, work, dev, smi, ds)
    uniform_launches = phase("uniform training", phase_uniform_train, work, dev, smi)
    _, o2_launches = phase("second object", phase_second_object, work, dev)
    composed, per_sample, root, scene = phase("composition", phase_composition, work, dev, smi)
    loaded, march, pose = phase("composition reference", phase_composition_reference, root, scene, dev)
    phase("compose profile", phase_compose_profile, loaded, march, pose)
    del loaded, march
    phase("baked reference", phase_baked_reference, dev)
    baked_runs, volumes = phase("baked composition", phase_baked_compose, work, root, scene, dev, smi, per_sample)
    phase("baked profile", phase_baked_profile, volumes, pose, dev, smi)
    del volumes
    phase("procedural", phase_procedural, work, dev, smi)
    phase("voxel reference", phase_voxel_reference, dev)
    voxel_launches = phase("voxel", phase_voxel, work, dev, smi)
    phase("voxel profile", phase_voxel_profile, work, dev, smi)
    dnerf_launches, dnerf_trainer = phase("dnerf", phase_dnerf, work, dev, smi)
    march_entry["max_abs_err"] = max(march_entry["max_abs_err"],
                                     phase("march kernel (dnerf)", phase_march_dnerf, dnerf_trainer, dev))
    phase("dnerf reference", phase_dnerf_reference, dnerf_trainer, dev)
    del dnerf_trainer
    phase("dnerf variants", phase_dnerf_variants, work, dev, smi)
    viewer_launches = phase("viewer", phase_viewer, work, dev, smi)
    phase("lpips", phase_lpips, work, dev, smi)
    no_preload_launches = phase("no-preload", phase_no_preload, work, dev, smi, ds)
    clip_launches = phase("clip", phase_clip, work, dev, smi, ds)
    parallel_launches = phase("parallel", phase_parallel, work, dev, smi, trainer, ds)
    print(f"[done] all phases in {time.time() - t_start:.1f} s")

    line = [{**k, "launches": launches[k["name"]], "launches_compose": composed["combined"][k["name"]],
             "launches_edit": composed["editable"][k["name"]],
             "launches_baked_compose": baked_runs["combined"][k["name"]],
             "launches_baked_edit": baked_runs["editable"][k["name"]],
             "launches_voxel": voxel_launches[k["name"]], "launches_uniform": uniform_launches[k["name"]],
             "launches_o2": o2_launches[k["name"]], "launches_dnerf": dnerf_launches[k["name"]],
             "launches_viewer": viewer_launches[k["name"]], "launches_no_preload": no_preload_launches[k["name"]],
             "launches_clip": clip_launches[k["name"]], "launches_parallel": parallel_launches[k["name"]],
             "launches_fused": fused_launches[k["name"]]}
            for k in kernels]
    print(f"[device] nvidia-smi: {smi}")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
