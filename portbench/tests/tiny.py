"""A tiny checkout of the benchmark for CPU tests: the cells at test size.

``make_checkout(tmp)`` copies ``portbench/`` into ``tmp`` beside a
``BENCHMARK.json`` whose cells run a 4-level field on a 24 x 24 scene,
with their own limits: the same numbers the real cells compare, with
limits set from CPU readings at this size (four seeds). Training (the
first refresh's densities, every checked step's loss, first gradient,
change; the end steps' change): the program's plain paths read 0, 0, up to
1.1e-7, up to 8.5e-8, up to 1.4e-7; the fp8 control 2.5e-6 to 3.6e-6,
9.6e-4 to 9.1e-3, 0.017 to 0.094, 0.0095 to 0.051, 0.0089 to 0.026; half
the batch 0, 0.20 to 0.34, 0.14 to 0.57, 0.10 to 0.12, 0.035 to 0.072.
Serving (image 99th percentile, depth): the program 9.1e-6 to 1.2e-5,
1.6e-6 to 2.4e-6; the fp8 control 6.5e-4 to 8.9e-4, 5.1e-5 to 2.7e-4.
"""

from __future__ import annotations

import json
import os
import shutil
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PORTBENCH = os.path.dirname(HERE)
REPO = os.path.dirname(PORTBENCH)

TINY_SCENE = {"name": "tiny", "H": 24, "W": 24, "n_train": 4, "n_val": 1, "n_test": 3, "gt_res": 32,
              "extent": 1.6, "radius": 4.0, "bound": 2.0}
LIMITS = {"train": {"grid_gap": 1e-6, "loss_gap": 3e-5, "grad_gap": 1e-2, "update_gap": 2e-2,
                   "end_update_gap": 2e-2},
          "render": {"image_p99_gap": 5e-5, "depth_gap": 1e-5}}


def make_checkout(tmp: str) -> str:
    root = os.path.join(tmp, "checkout")
    shutil.copytree(PORTBENCH, os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    with open(os.path.join(PORTBENCH, "configs", "ngp-object.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny", num_levels=4, base_resolution=4, log2_hashmap_size=12, hidden_dim=16, hidden_dim_color=16)
    with open(os.path.join(root, "portbench", "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = []
    for w in bench["workloads"]:
        with open(os.path.join(PORTBENCH, "traffic", f"{w['traffic']}.json")) as f:
            tr = json.load(f)
        tr.update(scene=TINY_SCENE, trace_epochs=1)
        if "num_rays" in tr:
            tr["num_rays"] = 64
        name = f"tiny.{w['traffic']}"
        with open(os.path.join(root, "portbench", "traffic", f"tiny-{w['traffic']}.json"), "w") as f:
            json.dump(tr, f)
        with open(os.path.join(root, "portbench", "limits", f"{name}.json"), "w") as f:
            json.dump(LIMITS[tr["generator"]], f)
        cells.append(dict(w, name=name, config="tiny", traffic=f"tiny-{w['traffic']}"))
    bench["workloads"] = cells
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [f"tiny.{w.split('.', 1)[1]}" for w in m["workloads"]]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def run_cell(root: str, name: str, seed: int = 12345678901, seconds: float = 0.5, trace: bool = False) -> dict:
    from portbench import harness

    return harness.execute(root, name, seed, seconds, trace, "cpu", time.perf_counter())
