"""D-NeRF trainer: the shared ``Trainer`` with time threaded everywhere.

Twin of focnerf_tpu/train/dnerf_trainer.py (dnerf/utils.py, the time axis
of dnerf/renderer.py:74,286), through the base trainer's hooks:

  - ``_create_state``: the D-NeRF params of the config's variant;
  - ``_init_occupancy``: the time grid [time_slots, CAS, H^3]; no
    ``mark_untrained`` (the reference has none for D-NeRF);
  - ``_maybe_update_occupancy``: every ``update_extra_interval`` steps one
    slot is refreshed, round-robin (slot = (step // interval) % slots);
  - ``_occ_bits_for_batch(batch)``: the bitfield of the batch's time slot
    or, under ``skip_march``, its skip field. JAX rebuilds the skip field
    every step; here it is cached per slot and the cache is dropped at each
    refresh (the refresh moves the mean, hence every slot's threshold): the
    same values. Reading the slot costs one host sync a step;
  - ``_step``: ``dnerf_train_step_occupancy`` at ``train_slab`` (JAX's
    D-NeRF trainer does not re-bucket the slab), or the uniform
    ``dnerf_train_step`` without the grid;
  - ``_render_view``: ``render_image_dnerf`` at the view's time (the
    occupancy path through the slot's bitfield with the ladder march, slab
    max(train_slab, 64)); the ``eval_renderer`` option does not apply;
  - ``save_mesh(t=...)``: the EMA field's iso-surface at time t, named
    ``<name>_<epoch>_t{t:.2f}.obj``.

Checkpoints carry the time grid (the base ``CheckpointManager`` saves any
occupancy state's fields) and a resume restores it.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from focnerf_tpu_torch.models.dnerf import dnerf_density, init_dnerf_params
from focnerf_tpu_torch.ops.occupancy import (
    OccupancyState,
    cascade_count,
    occupancy_draws,
    occupancy_skip_field,
)
from focnerf_tpu_torch.render.dnerf_renderer import (
    TimeOccupancyState,
    init_time_occupancy,
    render_image_dnerf,
    time_occupancy_bitfield,
    time_slot_of,
    update_time_occupancy,
)
from focnerf_tpu_torch.train.dnerf_steps import dnerf_step_draws, dnerf_train_step, dnerf_train_step_occupancy
from focnerf_tpu_torch.train.state import TrainState
from focnerf_tpu_torch.train.trainer import Trainer


class DNeRFTrainer(Trainer):
    # its own step (per-slot skip fields, the time draws): per-step, as
    # JAX's DNeRFTrainer, whose _build_steps never enables the fused chunk
    _supports_fused = False

    def __init__(self, *args, time_slots: int = 64, **kw):
        self.time_slots = time_slots
        self._slot_cache = {}  # time slot -> its skip field, until the next refresh
        super().__init__(*args, **kw)

    # ---------------------------------------------------------------- hooks
    def _create_state(self, seed: int) -> TrainState:
        params = init_dnerf_params(torch.Generator().manual_seed(seed), self.cfg, self.device)
        return TrainState(params, **self._state_kw)

    def _init_occupancy(self):
        return init_time_occupancy(self.cfg.bound, self.device, time_slots=self.time_slots)

    def _adopt(self, restored: dict, weights_only: bool = False):
        super()._adopt(restored, weights_only)
        if isinstance(self.occupancy, OccupancyState):  # the checkpoint's time grid, as restored
            occ = TimeOccupancyState(*self.occupancy)
            want = (self.time_slots, cascade_count(self.cfg.bound), 128**3)
            if tuple(occ.density_grid.shape) != want:
                raise ValueError(f"checkpoint time grid {tuple(occ.density_grid.shape)} does not match "
                                 f"{want} (--time_slots {self.time_slots})")
            self.occupancy = occ

    def _mark_untrained(self, train_dataset):
        return  # every slot starts at 0; the reference marks nothing for D-NeRF

    def _maybe_update_occupancy(self):
        if self.occupancy is None or self.global_step % self.update_extra_interval != 0:
            return
        slot = (self.global_step // self.update_extra_interval) % self.time_slots
        draws = occupancy_draws(self.generator, self.occupancy.density_grid.shape[1], True, self.device)
        params, cfg = self.state.params, self.cfg
        self.occupancy = update_time_occupancy(
            self.occupancy, lambda x, t: dnerf_density(params, cfg, x, t)[0], draws, bound=cfg.bound,
            time_slot=slot, density_scale=cfg.density_scale,
        )
        self._slot_cache.clear()

    def _occ_bits_for_batch(self, batch=None):
        if not self.skip_march:
            return time_occupancy_bitfield(self.occupancy, batch["time"], self.density_thresh)
        slot = int(time_slot_of(self.occupancy, batch["time"]))
        if slot not in self._slot_cache:
            thresh = torch.clamp(self.occupancy.mean_density, max=self.density_thresh)
            self._slot_cache[slot] = occupancy_skip_field(self.occupancy.density_grid[slot] > thresh)
        return self._slot_cache[slot]

    def _step(self, batch):
        n = batch["rays_o"].shape[0]
        if self.occupancy is not None:
            occ = self._occ_bits_for_batch(batch)
            draws = dnerf_step_draws(self.generator, n, self.device)
            metrics = dnerf_train_step_occupancy(
                self.state, batch, occ, draws, cfg=self.cfg, dt_gamma=self.dt_gamma, max_steps=self.max_steps,
                slab=self.train_slab, min_near=self.min_near, skip_field=self.skip_march,
            )
            self._last_mean_samples = metrics["mean_samples"]
            return metrics
        draws = dnerf_step_draws(self.generator, n, self.device, num_steps=self.num_steps)
        return dnerf_train_step(self.state, batch, draws, cfg=self.cfg, num_steps=self.num_steps,
                                min_near=self.min_near)

    def _render_kwargs(self) -> dict:
        # the occupancy bits depend on the view's time: _render_view adds them
        return dict(num_steps=self.num_steps, max_ray_batch=self.max_ray_batch, min_near=self.min_near)

    def _render_view(self, params, view, dataset, render_kwargs):
        kw = dict(render_kwargs)
        if self.occupancy is not None:
            kw.update(occ_bits=time_occupancy_bitfield(self.occupancy, view["time"], self.density_thresh),
                      dt_gamma=self.dt_gamma, max_steps=self.max_steps, slab=max(self.train_slab, 64))
        return render_image_dnerf(params, self.cfg, view["pose"], dataset.intrinsics, dataset.H, dataset.W,
                                  view["time"], bg_color=1.0, **kw)

    def _mesh_density(self, params, t: float = 0.0):
        cfg = self.cfg
        return lambda x: dnerf_density(params, cfg, x, t)[0]

    def save_mesh(self, resolution: int = 256, threshold: float = 10.0, path: Optional[str] = None,
                  t: float = 0.0):
        """The EMA field's density iso-surface at time ``t`` (dnerf/utils.py:221-243)
        -> its path."""
        from focnerf_tpu_torch.utils.mesh_extract import extract_mesh, save_obj

        verts, faces = extract_mesh(self._mesh_density(self.state.ema_params, t=t), bound=self.cfg.bound,
                                    resolution=resolution, threshold=threshold, device=self.device)
        if path is None:
            os.makedirs(os.path.join(self.workspace, "meshes"), exist_ok=True)
            path = os.path.join(self.workspace, "meshes", f"{self.name}_{self.epoch}_t{t:.2f}.obj")
        save_obj(path, verts, faces)
        self.log(f"[mesh t={t:.2f}] saved {path} ({len(verts)} verts, {len(faces)} faces)")
        return path
