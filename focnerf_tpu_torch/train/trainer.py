"""Training orchestration: epochs, eval, occupancy maintenance, checkpoints.

Twin of focnerf_tpu/train/trainer.py: the constructor's checkpoint modes
(:237-280) and coarse-to-fine schedule (:192-217), ``train`` (:705-764) with
the occupancy cadence (update every ``update_extra_interval`` steps,
:432-452), the bitfield / skip-field cache (:537-547), the slab buckets
(:454-475) and the error map's update after each step (:41-47, :745-750);
each step's config from ``_phase_cfg`` (:315-342: the c2f stage's active
levels, the gradient phase's level subset); the uniform-sampling step
without the occupancy grid; ``evaluate`` with PSNR/SSIM/LPIPS and the best
checkpoint (:791-842), ``test`` (:844-880) and ``save_mesh`` (:895-912). A
view renders as ``_render_view`` (:378-418) has it: with the occupancy
grid, the ``iter``/``iter_dev`` eval renderers go through
render/iterative.py, everything else through the oneshot ``render_image``.

A subclass (the D-NeRF trainer) replaces these hooks, as the JAX
``Trainer``'s subclasses do: ``_create_state`` (the params and their
``TrainState``), ``_init_occupancy``, ``_mark_untrained``,
``_maybe_update_occupancy``, ``_occ_bits_for_batch(batch)``, ``_step``
(one optimizer step on a drawn batch), ``_render_view``/``_render_kwargs``
and ``_mesh_density``.

Every draw comes from one ``torch.Generator`` on the training device,
seeded by ``seed``; the rand poses from a numpy generator seeded by ``seed
+ 1``, as JAX's.

``steps_per_dispatch`` K > 1 is JAX's fused dispatch (:577-727): where a
chunk of n in {K} and the powers of two below it fits before the epoch's
end, the next occupancy tick and the next c2f stage (and starts on phase 0
of ``grad_level_phases``), n steps run as one ``train/fused.py`` chunk:
their draws are drawn first in the per-step loop's order, and on the card
each step replays a CUDA graph. The chunk's steps are the per-step loop's.
It stays per-step where JAX's does: ``rand_pose`` >= 0, no preloaded
images (``--no-preload``), a subclass with its own step (D-NeRF).

The CLIP rand-pose branch (:477-522, the reference's nerf/utils.py:796-838):
with ``rand_pose`` 0 every step, with ``rand_pose`` N > 0 the steps with
``global_step % (N + 1) == N``, are GT-free CLIP steps
(``steps.make_clip_step`` on ``rand_pose_batch``, ``min(num_steps, 128)``
samples a ray, the full config). A CLIP step comes before the occupancy
update and counts in ``global_step``, so the refreshes fall where JAX's
do. The loss is ``clip_loss_fn``, else ``make_torch_clip_loss(clip_text)``;
when neither gives one the trainer says so once, sets ``rand_pose`` to -1
and trains on, as JAX's does. JAX runs the branch from ``train_step_once``
only (its ``train`` never reaches it); the port runs it from both, so
``main_nerf --rand_pose`` does what it says.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional

import numpy as np
import torch

from focnerf_tpu_torch import resolve_device
from focnerf_tpu_torch.models.nerf import NeRFConfig, density_fn, init_nerf_params
from focnerf_tpu_torch.ops.occupancy import (
    init_occupancy,
    mark_untrained_grid,
    occupancy_bitfield,
    occupancy_draws,
    occupancy_skip_field,
    update_occupancy,
)
from focnerf_tpu_torch.render.iterative import render_image_iterative
from focnerf_tpu_torch.render.renderer import render_image
from focnerf_tpu_torch.train.checkpoints import BestCheckpoint, CheckpointManager, save_model_config
from focnerf_tpu_torch.train.meters import LPIPSMeter, PSNRMeter, SSIMMeter
from focnerf_tpu_torch.train.state import TrainState
from focnerf_tpu_torch.train.steps import (
    clip_step_draws,
    make_clip_step,
    step_draws,
    train_step,
    train_step_occupancy,
    uniform_step_draws,
    update_error_map,
)

EVAL_RENDERERS = ("oneshot", "iter", "iter_dev")


def _host_ints(values) -> List[int]:
    """Host ints of a list of ints and int tensors (one sync for all)."""
    tensors = [v.reshape(-1).to(torch.int64) for v in values if torch.is_tensor(v)]
    read = iter(torch.cat(tensors).tolist() if tensors else ())
    out: List[int] = []
    for v in values:
        out += [int(next(read)) for _ in range(v.numel())] if torch.is_tensor(v) else [int(v)]
    return out


class Trainer:
    _supports_fused = True  # a subclass with its own step opts out (D-NeRF)

    def __init__(
        self,
        name: str,
        cfg: NeRFConfig,
        workspace: str = "workspace",
        *,
        lr: float = 1e-2,
        lr_net=None,
        lr_warmup: int = 0,
        alpha_loss: float = 0.0,
        grad_clip: float = 0.0,
        grad_level_phases: int = 0,
        c2f: str = "",
        iters: int = 30000,
        num_steps: int = 512,
        upsample_steps: int = 0,
        max_ray_batch: int = 4096,
        use_occupancy: bool = False,
        dt_gamma: float = 1 / 128,
        max_steps: int = 1024,
        train_slab: int = 128,
        density_thresh: float = 10.0,
        update_extra_interval: int = 16,
        ema_decay: float = 0.95,
        min_near: float = 0.2,
        color_space: str = "srgb",
        tv_weight: float = 0.0,
        bucket_slabs: bool = False,
        skip_march: bool = False,
        eval_interval: int = 50,
        steps_per_dispatch: int = 1,
        ckpt_interval: int = 1,
        eval_save_images: bool = True,
        eval_renderer: str = "oneshot",
        max_keep_ckpt: int = 2,
        use_checkpoint: str = "latest",
        seed: int = 0,
        rand_pose: int = -1,
        clip_text: str = "",
        clip_loss_fn=None,
        device=None,
    ):
        self.grad_level_phases = max(0, grad_level_phases)
        if self.grad_level_phases > 1 and not use_occupancy:
            raise ValueError("grad_level_phases > 1 requires the occupancy path; drop it or pass "
                             "use_occupancy=True / --cuda_ray")
        # "0.3:8,0.6:12": the first 8 levels until 30% of iters, 12 until
        # 60%, all after (a boundary <= 1 is a fraction of iters, > 1 a step)
        self.c2f_stages = []
        for part in filter(None, (p.strip() for p in c2f.split(","))):
            b, lv = part.split(":")
            end = int(round(float(b) * iters)) if float(b) <= 1.0 else int(float(b))
            self.c2f_stages.append((end, int(lv)))
        self.c2f_stages.sort()
        if self.c2f_stages:
            if not use_occupancy:
                raise ValueError("c2f schedule requires the occupancy path; drop c2f or pass "
                                 "use_occupancy=True / --cuda_ray")
            bad = [lv for _, lv in self.c2f_stages if not 0 < lv <= cfg.num_levels]
            if bad:
                raise ValueError(f"c2f levels {bad} outside [1, {cfg.num_levels}]")
        self.device = resolve_device(device)
        self.name = name
        self.cfg = cfg
        self.workspace = workspace
        self.iters = iters
        self.num_steps = num_steps
        self.upsample_steps = upsample_steps
        self.max_ray_batch = max_ray_batch
        self.use_occupancy = use_occupancy
        self.dt_gamma = dt_gamma
        self.max_steps = max_steps
        self.train_slab = train_slab
        self.bucket_slabs = bucket_slabs
        self.skip_march = skip_march
        self._occ_cache = None  # bitfield or skip field, rebuilt per occupancy update
        self._slab_buckets = sorted(
            {min(1 << i, train_slab) for i in range(4, 11) if (1 << i) <= train_slab} | {train_slab}
        )
        self.active_slab = train_slab
        self._mean_samples_ema = float(train_slab)
        self._last_mean_samples = None
        self.density_thresh = density_thresh
        self.update_extra_interval = update_extra_interval
        self.min_near = min_near
        self.color_space = color_space
        self.alpha_loss = alpha_loss
        self.tv_weight = tv_weight
        self.eval_interval = eval_interval
        self.ckpt_interval = max(1, int(ckpt_interval))
        self.eval_save_images = eval_save_images
        self.eval_renderer = eval_renderer
        self.epoch = 0
        self.global_step = 0
        self.last_eval_step = -1
        self.last_eval_results = None
        self.step_losses: List[float] = []  # every step's loss, read once per epoch
        self.march_iters: List[int] = []  # every occupancy step's walk iterations, read once per epoch
        self.rand_pose = rand_pose
        self._clip_text = clip_text
        self._clip_loss = clip_loss_fn
        self._clip_step_fn = None
        self._clip_warned = False
        self.clip_steps: List[int] = []  # the global steps that were CLIP steps
        self._np_rng = np.random.default_rng(seed + 1)

        self.steps_per_dispatch = max(1, int(steps_per_dispatch))
        self._fused_cache: dict = {}

        os.makedirs(workspace, exist_ok=True)
        self.log_path = os.path.join(workspace, f"log_{name}.txt")
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._state_kw = dict(lr=lr, iters=iters, lr_net=lr_net, warmup=lr_warmup, grad_clip=grad_clip,
                              ema_decay=ema_decay)
        self.state = self._create_state(seed)
        self.occupancy = self._init_occupancy() if use_occupancy else None
        self.metrics = [PSNRMeter(), SSIMMeter(), LPIPSMeter()]

        ckpt_dir = os.path.join(workspace, "checkpoints")
        self.ckpt = CheckpointManager(ckpt_dir, max_keep=max_keep_ckpt)
        save_model_config(ckpt_dir, cfg)
        self.best = BestCheckpoint(os.path.join(workspace, "best"))
        best = self.best.metric()
        self.best_psnr = best if best is not None else -np.inf

        # modes: scratch | latest | latest_model | best | <explicit path>
        # (ref nerf/utils.py:775-793)
        if use_checkpoint in ("latest", "latest_model"):
            restored = self.ckpt.restore(self.device)
            if restored is not None:
                self._adopt(restored, weights_only=use_checkpoint == "latest_model")
                self.log(f"[INFO] resumed ({use_checkpoint}) from step {restored['step']}")
        elif use_checkpoint == "best":
            restored = self.best.restore(self.device)
            if restored is not None:
                self._adopt(restored)
                self.log(f"[INFO] resumed best checkpoint (psnr={self.best_psnr:.2f}, "
                         f"step {self.global_step})")
            else:
                self.log("[WARN] no best checkpoint found; starting from scratch")
        elif use_checkpoint in ("scratch", ""):
            pass
        elif os.sep in use_checkpoint or os.path.isdir(use_checkpoint):
            restored = CheckpointManager(use_checkpoint).restore(self.device)
            if restored is not None:
                self._adopt(restored)
        else:
            raise ValueError(
                f"unknown checkpoint mode {use_checkpoint!r}; expected "
                "scratch | latest | latest_model | best | <path>"
            )

    # ------------------------------------------------------------------ hooks
    def _create_state(self, seed: int) -> TrainState:
        """The seeded params (drawn on the CPU) in a fresh ``TrainState``."""
        params = init_nerf_params(torch.Generator().manual_seed(seed), self.cfg, self.device)
        return TrainState(params, **self._state_kw)

    def _init_occupancy(self):
        return init_occupancy(self.cfg.bound, self.device)

    def _adopt(self, restored: dict, weights_only: bool = False):
        self.state.load_state_dict(restored, weights_only=weights_only)
        if weights_only:
            return
        occ = restored.get("occupancy")
        if occ is not None and self.occupancy is not None:
            self.occupancy = occ
        self.global_step = self.state.step

    def log(self, msg: str):
        print(msg)
        with open(self.log_path, "a") as f:
            f.write(msg + "\n")

    # ------------------------------------------------------------------ train
    def _mark_untrained(self, train_dataset):
        self.occupancy = mark_untrained_grid(
            self.occupancy, train_dataset.poses, train_dataset.intrinsics, bound=self.cfg.bound
        )

    def _maybe_update_occupancy(self):
        if self.occupancy is None or self.global_step % self.update_extra_interval != 0:
            return
        full = int(self.occupancy.iter_density) < 16  # the reference's rule
        draws = occupancy_draws(self.generator, self.occupancy.density_grid.shape[0], full,
                                self.device)
        params, cfg = self.state.params, self.cfg
        self.occupancy = update_occupancy(
            self.occupancy, lambda x: density_fn(params, cfg, x)[0], draws,
            bound=cfg.bound, density_scale=cfg.density_scale,
        )
        self._occ_cache = None  # bitfield/skip field must be rebuilt
        self._maybe_repick_slab()

    def _maybe_repick_slab(self):
        """Re-pick the slab bucket from the measured mean samples/ray (EMA),
        from step 256 on (truncating before pruning matures collapses
        quality, PERF.md)."""
        if not (self.bucket_slabs and self.use_occupancy) or self._last_mean_samples is None:
            return
        self._mean_samples_ema = 0.8 * self._mean_samples_ema + 0.2 * float(self._last_mean_samples)
        if self.global_step < 256:
            return
        want = 1.25 * self._mean_samples_ema
        new = next((b for b in self._slab_buckets if b >= want), self.train_slab)
        if new != self.active_slab:
            self.log(f"[slab] mean samples/ray {self._mean_samples_ema:.1f} -> "
                     f"bucket {self.active_slab} => {new}")
            self.active_slab = new

    def _occ_bits_for_batch(self, batch=None):
        """The bitfield (or skip field) the step marches through; one grid
        serves every batch here."""
        if self._occ_cache is None:
            bits = occupancy_bitfield(self.occupancy, self.density_thresh)
            self._occ_cache = occupancy_skip_field(bits) if self.skip_march else bits
        return self._occ_cache

    def _phase_cfg(self):
        """This step's config and its (phase, active levels): a c2f stage
        encodes its first ``active`` levels; with ``grad_level_phases`` P > 1
        step k trains the table rows of the active levels l with l % P ==
        k % P. Eval and the occupancy update keep the full ``self.cfg``."""
        cfgs, (P, active) = self._cfg_phase_list()
        phase = self.global_step % P
        return cfgs[phase], (phase, active)

    def _cfg_phase_list(self):
        """The configs of the gradient phases at this step's c2f stage ->
        ([cfg of phase 0, ..., P - 1], (P, active levels)); P = 1 without
        phases (JAX's ``_cfg_phase_list``)."""
        cfg, active = self.cfg, 0
        for end, lv in self.c2f_stages:
            if self.global_step < end:
                active = lv
                break
        if active:
            cfg = dataclasses.replace(cfg, active_levels=active)
        P = self.grad_level_phases
        if P <= 1:
            return [cfg], (1, active)
        n_lv = active or cfg.num_levels
        return [dataclasses.replace(cfg, grad_levels=tuple(lvl for lvl in range(n_lv) if lvl % P == phase))
                for phase in range(P)], (P, active)

    def _fused_steps_possible(self, train_dataset, remaining: int) -> int:
        """How many steps the next dispatch may fuse (1 = the per-step path):
        a chunk of n in {K} and the powers of two below K, at most the
        epoch's ``remaining`` steps, never across the next occupancy tick or
        c2f stage boundary, a multiple of P starting on phase 0 (JAX's
        ``_fused_steps_possible``)."""
        K = self.steps_per_dispatch
        if (
            K <= 1
            or not self._supports_fused
            or self.rand_pose >= 0
            or getattr(train_dataset, "images", None) is None
        ):
            return 1
        gs = self.global_step
        cap = remaining
        if self.occupancy is not None:
            # the tick at gs fired before this chunk; the next is at the next
            # multiple of the interval
            iv = self.update_extra_interval
            next_due = ((gs // iv) + 1) * iv if gs % iv else gs + iv
            cap = min(cap, next_due - gs)
        for end, _lv in self.c2f_stages:
            if gs < end:
                cap = min(cap, end - gs)
                break
        P = max(1, self.grad_level_phases)
        for n in sorted({K} | {1 << i for i in range(K.bit_length())}, reverse=True):
            if n <= 1:
                break
            if n <= cap and n % P == 0 and (P == 1 or gs % P == 0):
                return n
        return 1

    def _fused_chunk_fn(self, train_dataset):
        """The chunk of this stage, slab and dataset, made at its first use.
        A chunk of another stage or slab is dropped with its graphs."""
        from focnerf_tpu_torch.train.fused import make_fused_chunk

        cfgs, (P, active) = self._cfg_phase_list()
        has_em = train_dataset.error_map is not None
        key = (self.steps_per_dispatch, self.active_slab if self.use_occupancy else -1, P, active, has_em,
               train_dataset.masks_dev is not None, train_dataset.obj_feats_dev is not None, id(train_dataset))
        chunk = self._fused_cache.get(key)
        if chunk is not None:
            return chunk
        self._fused_cache.clear()
        common = dict(min_near=self.min_near, color_space=self.color_space, alpha_weight=self.alpha_loss,
                      tv_weight=self.tv_weight)

        def step_fn(cfg):
            if self.occupancy is not None:
                kw = dict(common, dt_gamma=self.dt_gamma, max_steps=self.max_steps, slab=self.active_slab,
                          skip_field=self.skip_march)
                return lambda state, batch, occ, draws, hyper: train_step_occupancy(
                    state, batch, occ, draws, cfg=cfg, hyper=hyper, **kw)
            kw = dict(common, num_steps=self.num_steps, upsample_steps=self.upsample_steps)
            return lambda state, batch, occ, draws, hyper: train_step(
                state, batch, draws, cfg=cfg, hyper=hyper, **kw)

        chunk = make_fused_chunk([step_fn(cfg) for cfg in cfgs], train_dataset.assemble_fn(),
                                 train_dataset.fused_batch_inputs(), K=self.steps_per_dispatch,
                                 device=self.device, has_error_map=has_em)
        self._fused_cache[key] = chunk
        return chunk

    def _step_draws(self, cfg, n_rays: int):
        """One step's draws from the generator, as ``_step`` draws them."""
        tv = self.tv_weight > 0.0
        if self.occupancy is not None:
            return step_draws(self.generator, cfg, n_rays, self.active_slab, self.device, tv=tv)
        return uniform_step_draws(self.generator, self.cfg, n_rays, self.num_steps, self.upsample_steps,
                                  self.device, tv=tv)

    def _run_fused_chunk(self, train_dataset, n: int):
        """Run n steps as one fused chunk -> (losses [n], march_iters [n]),
        on the device."""
        chunk = self._fused_chunk_fn(train_dataset)
        cfgs, (P, _) = self._cfg_phase_list()
        n_rays = min(train_dataset.opt.num_rays, train_dataset.H * train_dataset.W)
        draws, hypers = [], []
        for k in range(n):  # the per-step loop's order: batch draws, then the step's
            bd = train_dataset.batch_draws(self.generator)
            draws.append((bd, self._step_draws(cfgs[k % P], n_rays)))
            hypers.append(self.state.hyper(k))
        occ = self._occ_bits_for_batch(None) if self.occupancy is not None else None
        losses, msamples, iters = chunk.run(self.state, train_dataset.error_map, draws, hypers, occ)
        self.state.advance(n)
        self.global_step += n
        if self.occupancy is not None:
            # the per-step loop keeps the LAST step's mean samples; so does the
            # chunk, so the slab buckets move alike
            self._last_mean_samples = msamples[-1]
        return losses, iters

    def _maybe_clip_step(self, train_dataset):
        """A CLIP rand-pose step when one is scheduled -> its metrics, else None."""
        if self.rand_pose < 0:
            return None
        if self.rand_pose > 0 and self.global_step % (self.rand_pose + 1) != self.rand_pose:
            return None
        if self._clip_loss is None:
            if self._clip_text:
                from focnerf_tpu_torch.train.clip_guidance import make_torch_clip_loss

                self._clip_loss = make_torch_clip_loss(self._clip_text, device=self.device)
            if self._clip_loss is None:
                if not self._clip_warned:
                    self.log("[WARN] rand_pose >= 0 but no CLIP loss available (weights not cached / no "
                             "clip_text); skipping the rand-pose branch")
                    self._clip_warned = True
                self.rand_pose = -1
                return None
        batch = train_dataset.rand_pose_batch(self._np_rng)
        num_steps = min(self.num_steps, 128)
        if self._clip_step_fn is None:
            self._clip_step_fn = make_clip_step(self.cfg, self._clip_loss, H=int(batch["H"]), W=int(batch["W"]),
                                                num_steps=num_steps, min_near=self.min_near)
        draws = clip_step_draws(self.generator, self.cfg, batch["rays_o"].shape[0], num_steps, self.device)
        metrics = self._clip_step_fn(self.state, batch["rays_o"], batch["rays_d"], draws)
        self.clip_steps.append(self.global_step)
        self.global_step += 1
        return metrics

    def _train_step(self, train_dataset):
        """One optimizer step -> (its batch, None for a CLIP step; its
        metrics, the loss still on the device)."""
        metrics = self._maybe_clip_step(train_dataset)
        if metrics is not None:
            return None, metrics
        self._maybe_update_occupancy()
        batch = train_dataset.train_batch(self.generator)
        metrics = self._step(batch)
        self.global_step += 1
        return batch, metrics

    def _step(self, batch):
        """One optimizer step on ``batch`` -> its metrics: through the
        occupancy march when the trainer has the grid, else through uniform
        samples."""
        n = batch["rays_o"].shape[0]
        common = dict(min_near=self.min_near, color_space=self.color_space, alpha_weight=self.alpha_loss,
                      tv_weight=self.tv_weight)
        if self.occupancy is not None:
            cfg, _ = self._phase_cfg()
            slab = self.active_slab
            draws = self._step_draws(cfg, n)
            metrics = train_step_occupancy(
                self.state, batch, self._occ_bits_for_batch(batch), draws, cfg=cfg,
                dt_gamma=self.dt_gamma, max_steps=self.max_steps, slab=slab,
                skip_field=self.skip_march, **common,
            )
            self._last_mean_samples = metrics["mean_samples"]
        else:
            draws = self._step_draws(self.cfg, n)
            metrics = train_step(self.state, batch, draws, cfg=self.cfg, num_steps=self.num_steps,
                                 upsample_steps=self.upsample_steps, **common)
        return metrics

    def train_step_once(self, train_dataset):
        """One optimizer step -> its metrics (the loss still on the device)."""
        return self._train_step(train_dataset)[1]

    @staticmethod
    def _error_map_step(train_dataset, batch, metrics):
        """The error map's EMA at this step's cells, for its view, on the
        device (the view stays a tensor: no host sync)."""
        view = batch["view"].reshape(1)
        em = train_dataset.error_map
        new = update_error_map(em.index_select(0, view)[0], batch["inds_coarse"], metrics["per_ray_error"])
        em.index_copy_(0, view, new[None])

    def train(self, train_dataset, valid_dataset=None, max_epochs: int = 1,
              steps_per_epoch: Optional[int] = None):
        if steps_per_epoch is None:
            steps_per_epoch = train_dataset.n_views
        if self.epoch == 0 and self.global_step > 0 and steps_per_epoch > 0:
            # resumed: continue the epoch numbering so the cadences line up
            self.epoch = self.global_step // steps_per_epoch
        if self.occupancy is not None:
            self._mark_untrained(train_dataset)
        for _ep in range(max_epochs):
            self.epoch += 1
            t0 = time.time()
            losses, iters = [], []
            done = 0
            while done < steps_per_epoch:
                n = self._fused_steps_possible(train_dataset, steps_per_epoch - done)
                if n > 1:
                    # one chunk for n steps (train/fused.py): batch assembly,
                    # the steps and the error-map EMA, graph-replayed on the card
                    self._maybe_update_occupancy()
                    chunk_losses, chunk_iters = self._run_fused_chunk(train_dataset, n)
                    losses.append(chunk_losses)
                    if self.occupancy is not None:
                        iters.append(chunk_iters)
                    done += n
                    continue
                batch, metrics = self._train_step(train_dataset)
                losses.append(metrics["loss"].reshape(1))
                if "march_iters" in metrics:
                    iters.append(metrics["march_iters"])
                if batch is not None and getattr(train_dataset, "error_map", None) is not None \
                        and "inds_coarse" in batch:
                    self._error_map_step(train_dataset, batch, metrics)
                done += 1
            epoch_losses = torch.cat(losses).tolist()  # one sync per epoch
            self.march_iters += _host_ints(iters)
            self.step_losses += epoch_losses
            self.log(f"[epoch {self.epoch}] loss={np.mean(epoch_losses):.6f} "
                     f"steps={self.global_step} time={time.time() - t0:.1f}s")
            if valid_dataset is not None and self.epoch % self.eval_interval == 0:
                self.evaluate(valid_dataset, save_images=self.eval_save_images)
            if self.epoch % self.ckpt_interval == 0 or _ep == max_epochs - 1:
                self.save_checkpoint()

    # ------------------------------------------------------------------ eval
    def check_eval_renderer(self):
        """Raise on an eval renderer that does not exist."""
        if self.eval_renderer not in EVAL_RENDERERS:
            raise ValueError(f"eval_renderer {self.eval_renderer!r}: expected one of "
                             f"{', '.join(EVAL_RENDERERS)}")

    def _render_kwargs(self) -> dict:
        """render_image kwargs; the occupancy path whenever the model has a grid."""
        kw = dict(
            num_steps=self.num_steps,
            upsample_steps=self.upsample_steps,
            max_ray_batch=self.max_ray_batch,
            min_near=self.min_near,
        )
        if self.occupancy is not None:
            bits = occupancy_bitfield(self.occupancy, self.density_thresh)
            kw.update(occ_bits=bits, dt_gamma=self.dt_gamma, max_steps=self.max_steps,
                      slab=max(self.train_slab, 64))
            if self.skip_march:
                kw["occ_skip"] = occupancy_skip_field(bits)
        return kw

    def _render_view(self, params, view, dataset, render_kwargs):
        """Render one eval/test view -> (img [H, W, 3], depth [H, W])."""
        self.check_eval_renderer()
        if self.eval_renderer in ("iter", "iter_dev") and self.occupancy is not None:
            kw = render_kwargs
            occ_skip = kw.get("occ_skip")
            if occ_skip is None:
                occ_skip = occupancy_skip_field(kw["occ_bits"])
            return render_image_iterative(
                params, self.cfg, view["pose"], dataset.intrinsics, dataset.H, dataset.W,
                occ_skip=occ_skip, dt_gamma=kw.get("dt_gamma", 0.0),
                max_steps=kw.get("max_steps", 1024), min_near=kw.get("min_near", 0.2),
                obj_feat=view.get("obj_feat"), bg_color=1.0,
                device_loop=self.eval_renderer == "iter_dev",
            )
        return render_image(
            params, self.cfg, view["pose"], dataset.intrinsics, dataset.H, dataset.W,
            obj_feat=view.get("obj_feat"), bg_color=1.0, **render_kwargs,
        )

    def evaluate(self, dataset, name: str = "val", save_images=None, use_ema: bool = True):
        if save_images is None:
            save_images = self.eval_save_images
        params = self.state.ema_params if use_ema else self.state.params
        for m in self.metrics:
            m.clear()
        out_dir = os.path.join(self.workspace, "validation")
        os.makedirs(out_dir, exist_ok=True)
        render_kwargs = self._render_kwargs()
        for v in range(dataset.n_views):
            view = dataset.eval_view(v)
            img, _ = self._render_view(params, view, dataset, render_kwargs)
            if "pixels" in view:
                gt = view["pixels"].reshape(dataset.H, dataset.W, -1)
                if gt.shape[-1] == 4:
                    gt = gt[..., :3] * gt[..., 3:] + 1.0 * (1 - gt[..., 3:])
                # metrics on display-range images, as the saved PNG
                pred = torch.clamp(img, 0.0, 1.0)
                for m in self.metrics:
                    m.update(pred, gt)
            if save_images:
                self._save_image(
                    os.path.join(out_dir, f"{self.name}_{name}_{self.epoch:04d}_{v:04d}.png"),
                    img.cpu().numpy(),
                )
        self.log(f"[eval epoch {self.epoch}] " + " | ".join(m.report() for m in self.metrics))
        results = {m.name: m.measure() for m in self.metrics}
        self.last_eval_step = self.global_step
        self.last_eval_results = results
        psnr = results["PSNR"] if self.metrics[0].vals else None
        if psnr is not None and np.isfinite(psnr) and psnr > self.best_psnr:
            self.best_psnr = float(psnr)
            self.best.save(self.state.state_dict(), self.best_psnr)
            self.log(f"[INFO] new best checkpoint (PSNR {self.best_psnr:.2f})")
        return results

    def test(self, dataset, write_video: bool = True, use_ema: bool = True, save_gt: bool = False):
        """Render the test split to ``<workspace>/results``; returns uint8 frames."""
        params = self.state.ema_params if use_ema else self.state.params
        out_dir = os.path.join(self.workspace, "results")
        os.makedirs(out_dir, exist_ok=True)
        render_kwargs = self._render_kwargs()
        frames = []
        for v in range(dataset.n_views):
            view = dataset.eval_view(v)
            img, depth = self._render_view(params, view, dataset, render_kwargs)
            arr = img.cpu().numpy()
            frames.append((np.clip(arr, 0, 1) * 255).astype(np.uint8))
            self._save_image(os.path.join(out_dir, f"{self.name}_{v:04d}.png"), arr)
            self._save_image(
                os.path.join(out_dir, f"{self.name}_{v:04d}_depth.png"), depth.cpu().numpy()
            )
            if save_gt and "pixels" in view:
                gt = view["pixels"].cpu().numpy().reshape(dataset.H, dataset.W, -1)
                if gt.shape[-1] == 4:
                    gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:])
                self._save_image(os.path.join(out_dir, f"{self.name}_{v:04d}_gt.png"), gt)
        if write_video and len(frames) > 1:
            from focnerf_tpu_torch.utils.video import write_video as _wv

            _wv(os.path.join(out_dir, f"{self.name}.mp4"), frames, fps=25)
        return frames

    @staticmethod
    def _save_image(path: str, arr: np.ndarray):
        from focnerf_tpu_torch.data.png import write_image

        if arr.ndim == 2:
            arr = arr / max(float(arr.max()), 1e-6)
            arr = np.repeat(arr[..., None], 3, -1)
        write_image(path, (np.clip(arr, 0, 1) * 255).astype(np.uint8))

    # ------------------------------------------------------------------ ckpt/mesh
    def save_checkpoint(self):
        self.ckpt.save(self.state.state_dict(), self.occupancy)

    def save_mesh(self, resolution: int = 256, threshold: float = 10.0, path: Optional[str] = None):
        """The EMA field's density iso-surface at ``threshold`` on a
        ``resolution``^3 grid over the bound box, as an OBJ (utils.py:971-992,
        512-542) -> its path."""
        from focnerf_tpu_torch.utils.mesh_extract import extract_mesh, save_obj

        verts, faces = extract_mesh(self._mesh_density(self.state.ema_params), bound=self.cfg.bound,
                                    resolution=resolution, threshold=threshold, device=self.device)
        if path is None:
            os.makedirs(os.path.join(self.workspace, "meshes"), exist_ok=True)
            path = os.path.join(self.workspace, "meshes", f"{self.name}_{self.epoch}.obj")
        save_obj(path, verts, faces)
        self.log(f"[mesh] saved {path} ({len(verts)} verts, {len(faces)} faces)")
        return path

    def _mesh_density(self, params):
        return lambda x: density_fn(params, self.cfg, x)[0]
