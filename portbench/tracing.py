"""Spans the benchmark records around the program's calls, and the reduction
of a torch.profiler trace.

``union_s`` is the arithmetic of ``focnerf_tpu_torch/utils/measure.py``'s
``union_ms``, copied here so that the yardstick stays with the benchmark:
the device is busy for the union of its events' intervals, overlapping
events counted once.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, List, Tuple

import torch


def union_s(spans) -> float:
    """Length in seconds of the union of (start_us, end_us) intervals."""
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi <= end:
            continue
        total += hi - max(lo, end)
        end = hi
    return total / 1e6


def gaps(spans) -> List[Tuple[float, float]]:
    """The idle (start_us, end_us) intervals between the union's pieces."""
    out, end = [], None
    for lo, hi in sorted(spans):
        if end is not None and lo > end:
            out.append((end, lo))
        end = hi if end is None else max(end, hi)
    return out


class Spans:
    """Host spans (closed after a device sync) and device spans (CUDA
    events around a function), summed by name."""

    def __init__(self):
        self.host: Dict[str, float] = collections.defaultdict(float)
        self.events: Dict[str, list] = collections.defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        if sync and torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync and torch.cuda.is_available():
                torch.cuda.synchronize()
            self.host[name] += time.perf_counter() - t0

    def total(self, name: str) -> float:
        return self.host[name]

    def device_span(self, name: str, fn):
        """``fn`` wrapped in CUDA events (no host sync): its stream time."""

        def timed(*args, **kwargs):
            if not torch.cuda.is_available():  # a CPU run: the host's clock
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                self.host[name] += time.perf_counter() - t0
                return out
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.events[name].append((start, end))
            return out

        return timed

    def device_total(self, name: str) -> float:
        if self.events[name]:
            torch.cuda.synchronize()
        return self.host[name] + sum(s.elapsed_time(e) for s, e in self.events[name]) / 1e3


class _Profiled:
    summary: dict = {}


@contextlib.contextmanager
def profiled(device):
    """torch.profiler over the block, reduced on exit to ``summary``: the
    block's wall seconds (closed after a device sync), the device's busy
    seconds (the union of its events), every device event (name, start_us,
    end_us), and the host's CUDA runtime calls (name, start_us, end_us) to
    name the idle gaps by. On a card it records the CUDA activity alone:
    recording every host op as well doubled a served view's wall time."""
    from torch.profiler import ProfilerActivity, profile

    out = _Profiled()
    acts = [ProfilerActivity.CUDA] if device.type == "cuda" else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield out
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.events():
        rec = (e.name, e.time_range.start, e.time_range.end)
        if str(e.device_type).endswith("CUDA"):
            if not getattr(e, "is_user_annotation", False):
                dev.append(rec)
        elif e.time_range.end > e.time_range.start:
            host.append(rec)
    out.summary = {"wall_s": wall, "busy_s": union_s((s, e) for _, s, e in dev), "device": dev, "host": host}


def breakdown(summary: dict) -> dict:
    """The ten device ops that took most time (summed by name, seconds) and
    the ten longest idle gaps, each named by the innermost host op running
    when the gap began."""
    by_op = collections.defaultdict(float)
    for name, s, e in summary["device"]:
        by_op[name] += (e - s) / 1e6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    host = sorted(summary["host"], key=lambda r: r[1])
    named = []
    for lo, hi in sorted(gaps((s, e) for _, s, e in summary["device"]), key=lambda g: g[0] - g[1])[:10]:
        inner = [r for r in host if r[1] <= lo < r[2]]
        label = min(inner, key=lambda r: r[2] - r[1])[0] if inner else "host (no op)"
        named.append([label, (hi - lo) / 1e6])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


def device_time(summary: dict, substring: str) -> Tuple[float, int]:
    """(seconds, events) of the device events whose name holds ``substring``."""
    hits = [(s, e) for name, s, e in summary["device"] if substring in name]
    return sum(e - s for s, e in hits) / 1e6, len(hits)
