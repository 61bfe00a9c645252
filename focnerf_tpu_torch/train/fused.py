"""Fused multi-step training: K optimizer steps in one dispatch.

Twin of focnerf_tpu/train/fused.py (``make_fused_chunk``). JAX moves the
step loop onto the device as a ``lax.scan`` over K steps (batch assembly,
the train step, the error-map EMA), one dispatch for K steps. The port's
chunk runs the same K steps from staged buffers:

  - every random number of the K steps is drawn BEFORE the chunk, from the
    trainer's generator in the per-step loop's order (the view and pixel
    draws, then the step's draws, step after step), so they are the K
    sequential steps' numbers; so are the step-dependent factors of the
    optimizer update (``TrainState.hyper``: learning rate, bias
    corrections, EMA decay), staged as fp32 values;
  - a step reads slot ``k`` of those [K, ...] buffers through a slot counter
    on the device, and ends by adding one to it;
  - with ``grad_level_phases`` P > 1 each phase has its own step (its level
    subset is fixed in the step), run in phase order, as JAX unrolls P
    sub-steps per scan step.

On the CPU the chunk is that loop, run as it is: the steps, their batches and
their updates are the per-step loop's, bit for bit (tests/test_torch_fused.py).
On the card each distinct step is captured ONCE into a CUDA graph
(``torch.cuda.graph``) and replayed: one captured step that reads slot k,
replayed K times, rather than a graph of K unrolled steps, because a
capture then costs one step's time and memory whatever K is, and one graph
serves every chunk length of the schedule ({K} and the powers of two below
it). The first run of a step is a real step, eager, on a side stream (it
warms up the libraries, the lazily built kernels and constants, and the
optimizer's moments); the capture follows it and records the same work
without running it. Nothing in a step syncs the host or takes a
data-dependent shape: the skip walk is the march kernel, the bound box
and the shear-warp corners are cached on the device. A capture that fails
raises; it never falls back to the per-step path.

A graph replay launches the kernels it captured without passing through
their wrappers, so ``GraphedSteps`` adds each captured launch to its
wrapper's count per replay, and takes back what the capture itself added
(a capture launches nothing).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from focnerf_tpu_torch.ops import kernel_wrappers
from focnerf_tpu_torch.train.steps import update_error_map


class GraphedSteps:
    """Steps that read slot ``slot`` of staged buffers and add one to it.

    ``run(key, fn)`` runs the step ``fn``: on the CPU as it is; on the card
    from the CUDA graph of ``key``, captured at the step's first run (which
    runs it for real first). ``replays`` and ``captures`` count them.
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self.slot = torch.zeros((1,), dtype=torch.int64, device=self.device)
        self.graphs: Dict[object, tuple] = {}
        self.replays = 0
        self.captures = 0
        self._stream = None

    def start(self):
        """Point the next step at slot 0."""
        self.slot.zero_()

    def run(self, key, fn: Callable[[], None]):
        if self.device.type != "cuda":
            fn()
            return
        entry = self.graphs.get(key)
        if entry is None:
            self.graphs[key] = self._capture(key, fn)
            return
        graph, launched = entry
        graph.replay()
        self.replays += 1
        for wrapper, n in launched:
            wrapper.launches += n

    def _capture(self, key, fn):
        current = torch.cuda.current_stream(self.device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            fn()  # a real step; the graph records the same work below
        current.wait_stream(self._stream)
        wrappers = kernel_wrappers()
        before = [w.launches for w in wrappers]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                fn()
        except Exception as e:
            raise RuntimeError(f"fused dispatch: capturing step {key!r} into a CUDA graph failed "
                               f"({type(e).__name__}: {e}); run with steps_per_dispatch 1") from e
        finally:
            after = [w.launches for w in wrappers]
            for w, b in zip(wrappers, before):
                w.launches = b  # the capture ran nothing
        self.captures += 1
        return graph, [(w, a - b) for w, a, b in zip(wrappers, after, before) if a != b]


def _slot(buf: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Row ``slot`` ([1] int64 on the buffer's device) of a [K, ...] buffer."""
    return buf.index_select(0, slot)[0]


class Staged:
    """[K, ...] device buffers, one per key of a step's dict of tensors,
    made at the first ``put`` from its shapes; ``take(slot)`` reads a row
    of each. The buffers stay at their addresses: a graph reads them."""

    def __init__(self, K: int):
        self.K = K
        self.bufs: Optional[Dict[str, torch.Tensor]] = None

    def put(self, k: int, values: Dict[str, torch.Tensor]):
        if self.bufs is None:
            self.bufs = {name: torch.empty((self.K, *v.shape), dtype=v.dtype, device=v.device)
                         for name, v in values.items()}
        if values.keys() != self.bufs.keys():
            raise ValueError(f"staged keys {sorted(values)} differ from {sorted(self.bufs)}")
        for name, v in values.items():
            self.bufs[name][k].copy_(v)

    def take(self, slot: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {name: _slot(buf, slot) for name, buf in self.bufs.items()}


def stage_hyper(hypers: Sequence[dict], device) -> torch.Tensor:
    """K steps' ``TrainState.hyper`` factors -> fp32 [K, G + 3] on ``device``
    (the G groups' ``neg_step``, then ``inv_bc2``, ``d``, ``omd``), copied
    there without a host sync (pinned memory on the card)."""
    rows = [[*h["neg_step"], h["inv_bc2"], h["d"], h["omd"]] for h in hypers]
    host = torch.tensor(rows, dtype=torch.float32)
    if torch.device(device).type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host


def hyper_row(row: torch.Tensor) -> dict:
    """A staged hyper row [G + 3] -> ``TrainState.update``'s factors, as 0-d
    tensors."""
    return {"neg_step": list(row[:-3].unbind()), "inv_bc2": row[-3], "d": row[-2], "omd": row[-1]}


class FusedChunk:
    """The K-step chunk of a trainer (``make_fused_chunk``'s result).

    ``run(state, error_map, draws, hypers, occ)`` runs n = len(draws) steps:
    ``draws`` [(batch draws, step draws)] per step, ``hypers`` the
    ``TrainState.hyper`` factors per step, ``occ`` the grid the steps march
    through (copied into this chunk's own buffer, which the graphs read).
    Returns (losses [n], mean_samples [n], march_iters [n] int32), fresh
    device tensors. ``state`` must be the same object at every call (the
    graphs hold its tensors); the host counters are the caller's.
    """

    def __init__(self, step_fns: Sequence[Callable], assemble: Callable, inputs: tuple, *, K: int,
                 device, has_error_map: bool):
        self.P = len(step_fns)
        if K % self.P != 0:
            raise ValueError(f"K={K} must be a multiple of gradphase count {self.P}")
        self.K = K
        self.step_fns = list(step_fns)
        self.assemble = assemble
        self.inputs = inputs
        self.has_error_map = has_error_map
        self.device = torch.device(device)
        self.steps = GraphedSteps(self.device)
        self.batch_draws = Staged(K)
        self.step_draws = Staged(K)
        self.hyper: Optional[torch.Tensor] = None  # [K, G + 3], made at the first run
        self.losses = torch.zeros((K,), device=self.device)
        self.mean_samples = torch.zeros((K,), device=self.device)
        self.march_iters = torch.zeros((K,), dtype=torch.int32, device=self.device)
        self.occ: Optional[torch.Tensor] = None
        self._state = None
        self._error_map = None

    def _body(self, phase: int):
        slot = self.steps.slot
        batch = self.assemble(self.batch_draws.take(slot), *self.inputs, self._error_map)
        metrics = self.step_fns[phase](self._state, batch, self.occ, self.step_draws.take(slot),
                                       hyper_row(_slot(self.hyper, slot)))
        if self.has_error_map and "inds_coarse" in batch:
            view = batch["view"].reshape(1)
            em = self._error_map
            new = update_error_map(em.index_select(0, view)[0], batch["inds_coarse"], metrics["per_ray_error"])
            em.index_copy_(0, view, new[None])
        self.losses.index_copy_(0, slot, metrics["loss"].reshape(1))
        if "mean_samples" in metrics:
            self.mean_samples.index_copy_(0, slot, metrics["mean_samples"].reshape(1))
        it = metrics.get("march_iters", 0)
        if not torch.is_tensor(it):
            it = torch.full((1,), int(it), dtype=torch.int32, device=self.device)
        self.march_iters.index_copy_(0, slot, it.reshape(1).to(torch.int32))
        slot.add_(1)

    def run(self, state, error_map, draws: List[tuple], hypers: List[dict], occ=None):
        n = len(draws)
        if not 0 < n <= self.K or n % self.P:
            raise ValueError(f"a chunk of {n} steps: need 1..{self.K}, a multiple of {self.P}")
        if self._state is None:
            self._state, self._error_map = state, error_map
        elif state is not self._state or error_map is not self._error_map:
            raise ValueError("a fused chunk serves one train state and one error map")
        if occ is not None:
            if self.occ is None:
                self.occ = torch.empty_like(occ)
            self.occ.copy_(occ)
        for k, (bd, sd) in enumerate(draws):
            self.batch_draws.put(k, bd)
            self.step_draws.put(k, sd)
        staged = stage_hyper(hypers, self.device)
        if self.hyper is None:
            self.hyper = torch.zeros((self.K, staged.shape[1]), device=self.device)
        self.hyper[:n].copy_(staged)
        self.steps.start()
        for k in range(n):
            phase = k % self.P
            self.steps.run(phase, lambda p=phase: self._body(p))
        return self.losses[:n].clone(), self.mean_samples[:n].clone(), self.march_iters[:n].clone()


def make_fused_chunk(step_fns: Sequence[Callable], assemble: Callable, inputs: tuple, *, K: int, device,
                     has_error_map: bool) -> FusedChunk:
    """The K-step chunk (JAX's ``make_fused_chunk``).

    Args:
      step_fns: one step per gradient phase (length P; K a multiple of P),
        each ``step(state, batch, occ, draws, hyper)`` -> metrics, updating
        ``state`` in place with ``TrainState.update(hyper)``.
      assemble: the batch assembler (``data/provider.py::make_batch_assemble``).
      inputs: the assembler's device tensors (poses, images, masks,
        obj_feats; the last two may be None).
      has_error_map: update the per-view error map in each step.
    """
    return FusedChunk(step_fns, assemble, inputs, K=K, device=device, has_error_map=has_error_map)
