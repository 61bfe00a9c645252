"""One run of one cell: find its files by name, drive it, check it, report it.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix. The
harness reads ``configs/<config>.json``, ``traffic/<traffic>.json`` (whose
``generator`` names the general generator in ``generators/``) and
``limits/<cell>.json`` (the limit of every number the check compares:
after the window, with the program freed, ``compare_outputs`` of the
generator holds what the timed path produced to the plain reference),
and, in a ``--trace 1`` run, calls ``metrics/<metric>.py``'s ``read`` for
every per-layer metric that names the cell (or names no cell). A new
configuration, mix, cell or metric is new files and a new entry in
``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from typing import Optional

import torch

from portbench import tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "focnerf_tpu")


@dataclasses.dataclass
class Context:
    """What a generator and a metric reader see of the run."""

    root: str  # the checkout
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    workdir: str
    cache: str
    t_start: float
    marks: dict = dataclasses.field(default_factory=dict)
    window_start: Optional[float] = None

    def mark(self, name: str):
        """Seconds from the process's start to the end of a set-up stage."""
        self.marks[name] = time.perf_counter() - self.t_start

    def start_window(self):
        self.window_start = time.perf_counter()
        self.mark("window")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(root: str, bench: dict, name: str) -> dict:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]
    base = os.path.join(root, "portbench")
    return {
        "cell": cell,
        "config": _json(os.path.join(base, "configs", f"{cell['config']}.json")),
        "traffic": _json(os.path.join(base, "traffic", f"{cell['traffic']}.json")),
        "limits": _json(os.path.join(base, "limits", f"{name}.json")),
        "end_to_end": [m for m in bench["end_to_end"] if name in m.get("workloads", [name])],
        "per_layer": [m for m in bench["per_layer"] if name in m.get("workloads", [name])],
    }


def execute(root: str, name: str, seed: int, seconds: float, trace: bool, device, t_start: float,
            bench: Optional[dict] = None) -> dict:
    """Run cell ``name`` once on ``device`` -> the result (the printed line's
    keys, with ``checks`` and, traced, ``breakdown``); raises on a fault."""
    bench = bench if bench is not None else _json(os.path.join(root, "BENCHMARK.json"))
    files = cell_files(root, bench, name)
    device = torch.device(device)
    with tempfile.TemporaryDirectory(prefix="portbench-") as workdir:
        ctx = Context(root=root, cell=files["cell"], config=files["config"], traffic=files["traffic"], seed=seed,
                      seconds=seconds, trace=trace, device=device, workdir=workdir,
                      cache=os.path.join(root, "portbench", ".cache"), t_start=t_start)
        ctx.mark("imports")
        gen = importlib.import_module(f"portbench.generators.{files['traffic']['generator']}")
        with contextlib.redirect_stdout(sys.stderr):  # the program's prints; stdout is the result's
            out = gen.run(ctx)
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        check = out.pop("check_data")
        numbers = gen.compare_outputs(ctx, check)
        checks = {k: {"value": v, "limit": files["limits"][k]} for k, v in numbers.items()}
        correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
        result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"]}
        if trace:
            metrics = {}
            for m in files["per_layer"]:
                value = _module(os.path.join(root, "portbench", "metrics", f"{m['name']}.py"),
                                f"portbench_metric_{len(metrics)}").read(ctx, out["trace"])
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            prof = out["trace"]["profile"]
            result["breakdown"] = tracing.breakdown(prof)
            dev_extra = {"busy_s": prof["busy_s"], "window_s": prof["wall_s"]}
        else:
            setup_s = ctx.window_start - t_start
            metrics = {m["name"]: {"value": out["metrics"][m["name"]] if m["name"] != "setup_s" else setup_s,
                                   "unit": m["unit"]} for m in files["end_to_end"]}
            dev_extra = {}
        result["metrics"] = metrics
        result["device"] = {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": files["cell"]["chips"], "memory_peak_bytes": int(peak), **dev_extra,
        }
        result["setup_split_s"] = dict(ctx.marks)
        result["window_s"] = out["window_s"]
        result["diag"] = out.get("diag", {})
        result["checks"] = checks
        return result


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
