"""Tracing and stage timing.

Twin of focnerf_tpu/utils/profiling.py:

  - ``StageTimer``: named wall-clock stages; a stage synchronizes the
    device before it closes (torch returns before the card finishes), and
    ``write`` appends the summary to a text file, the reference's
    render_times.txt / train_times.txt convention;
  - ``trace(log_dir)``: ``torch.profiler`` over the block (the CPU, and the
    card when there is one), its Chrome trace written to
    ``<log_dir>/trace.json``; a no-op without ``log_dir``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch


def _synchronize(sync) -> None:
    """Wait for the card: for the devices of ``sync`` (a tensor or a list
    of them), else the current one once CUDA is in use."""
    tensors = [sync] if torch.is_tensor(sync) else list(sync or ())
    devices = {t.device for t in tensors if torch.is_tensor(t) and t.is_cuda}
    if not tensors and torch.cuda.is_initialized():
        devices = {torch.device("cuda", torch.cuda.current_device())}
    for d in devices:
        torch.cuda.synchronize(d)


class StageTimer:
    """Accumulates named stage timings; ``write`` appends to a text file."""

    def __init__(self):
        self.times: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        t0 = time.time()
        yield
        _synchronize(sync)
        self.times.setdefault(name, []).append(time.time() - t0)

    def summary(self) -> str:
        return "\n".join(
            f"{name}: n={len(vals)} total={sum(vals):.3f}s mean={sum(vals) / len(vals) * 1000:.1f}ms"
            for name, vals in self.times.items()
        )

    def write(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "a") as f:
            f.write(self.summary() + "\n")


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the block with ``torch.profiler``; yields the profiler (None
    without ``log_dir``)."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _synchronize(None)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
