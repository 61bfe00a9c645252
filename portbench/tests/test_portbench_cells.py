"""CPU tests of whole runs at test size: a cell added as new files only, the
program passing its check, the lower-precision control and the planted
faults failing it; and, on a card, one short run of each real cell."""

import json
import os
import subprocess
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

import tiny  # noqa: E402

from portbench import harness  # noqa: E402


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny.make_checkout(str(tmp_path_factory.mktemp("bench")))


def _ctx(root, name, seed=7):
    import tempfile
    import time

    with open(os.path.join(root, "BENCHMARK.json")) as f:
        files = harness.cell_files(root, json.load(f), name)
    return harness.Context(root=root, cell=files["cell"], config=files["config"], traffic=files["traffic"],
                           seed=seed, seconds=0.2, trace=False, device=torch.device("cpu"),
                           workdir=tempfile.mkdtemp(), cache=os.path.join(root, "portbench", ".cache"),
                           t_start=time.perf_counter()), files


def test_a_cell_added_as_new_files_only(checkout):
    """A new configuration, traffic mix, limits and per-layer metric: files
    and entries, and the harness runs the cell and reads the metric."""
    base = os.path.join(checkout, "portbench")
    with open(os.path.join(base, "configs", "tiny.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(base, "configs", "tiny-wide.json"), "w") as f:
        json.dump(dict(cfg, name="tiny-wide", hidden_dim_color=24), f)
    with open(os.path.join(base, "traffic", "tiny-render-test-800.json")) as f:
        tr = json.load(f)
    with open(os.path.join(base, "traffic", "tiny-views-2.json"), "w") as f:
        json.dump(dict(tr, check_views=1), f)
    with open(os.path.join(base, "limits", "tiny-wide.views-2.json"), "w") as f:
        json.dump(tiny.LIMITS["render"], f)
    with open(os.path.join(base, "metrics", "views.render.py"), "w") as f:
        f.write("def read(ctx, trace):\n    return float(len(trace['views']))\n")
    with open(os.path.join(checkout, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append(dict(bench["configs"][0], name="tiny-wide", file="portbench/configs/tiny-wide.json"))
    bench["workloads"].append({"name": "tiny-wide.views-2", "config": "tiny-wide", "traffic": "tiny-views-2",
                               "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "views.render", "unit": "views", "better": "higher", "source": "host_clock",
                               "layer": "renderer", "moves": "render_rays_per_s", "workloads": ["tiny-wide.views-2"]})
    for m in bench["end_to_end"]:
        if m["name"] == "render_rays_per_s":
            m["workloads"].append("tiny-wide.views-2")
    r = harness.execute(checkout, "tiny-wide.views-2", 99, 0.2, True, "cpu", 0.0, bench)
    assert r["correct"], r["checks"]
    assert r["metrics"]["views.render"]["value"] >= 1
    assert set(r["metrics"]) == {"views.render"}  # the other metrics name their cells
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell, e2e, rays", [("tiny.train-o-k16", "train_rays_per_s", 64),
                                             ("tiny.render-test-800", "render_rays_per_s", 24 * 24)])
def test_the_program_passes_its_check(checkout, cell, e2e, rays):
    """And the rate is all the window's work over all its time: every step's
    rays, or every view's pixels, over the window's wall seconds."""
    r = tiny.run_cell(checkout, cell)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {e2e, "setup_s"}
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["metrics"][e2e]["value"] == pytest.approx(r["attempted"] * rays / r["window_s"])
    assert r["window_s"] >= 0.5 and r["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("cell", ["tiny.train-o-k16", "tiny.render-test-800"])
def test_the_lower_precision_control_fails(checkout, cell):
    """The reference in fp8 (the configuration states bf16) put in the
    program's place fails at least one of the cell's limits; so does the
    planted half-batch fault of a training cell."""
    import contextlib
    import gc
    import importlib

    ctx, files = _ctx(checkout, cell)
    gen = importlib.import_module(f"portbench.generators.{files['traffic']['generator']}")
    with contextlib.redirect_stdout(sys.stderr):
        out = gen.run(ctx)
    check = out["check_data"]
    del out
    gc.collect()
    rows = gen.readings(ctx, check, control=True)
    limits = files["limits"]
    assert all(v <= limits[k] for k, v in rows["program"].items()), rows
    for name in {"control", "half_batch"} & set(rows):
        assert any(v > limits[k] for k, v in rows[name].items()), (name, rows)


def test_a_step_that_leaves_the_state_unchanged_fails(checkout, monkeypatch):
    from focnerf_tpu_torch.train.state import TrainState

    monkeypatch.setattr(TrainState, "update", lambda self, h: self.zero_grad())
    r = tiny.run_cell(checkout, "tiny.train-o-k16")
    assert not r["correct"] and r["checks"]["update_gap"]["value"] > 0.5


def test_half_the_batch_left_out_fails(checkout, monkeypatch):
    from focnerf_tpu_torch.train import trainer as trainer_mod

    step = trainer_mod.train_step_occupancy

    def half(state, batch, occ, draws, **kw):
        n = batch["rays_o"].shape[0] // 2
        slab = draws["u"].shape[0] // batch["rays_o"].shape[0]
        batch = {k: (v[:n] if torch.is_tensor(v) and v.dim() and v.shape[0] == 2 * n else v) for k, v in batch.items()}
        draws = {"bg": draws["bg"][:n], "noise": draws["noise"][:n], "u": draws["u"][:n * slab]}
        return step(state, batch, occ, draws, **kw)

    monkeypatch.setattr(trainer_mod, "train_step_occupancy", half)
    r = tiny.run_cell(checkout, "tiny.train-o-k16")
    assert not r["correct"], r["checks"]


def test_half_the_batch_left_out_in_the_fused_dispatch_fails(checkout, monkeypatch):
    """A fault in the fused chunk's steps alone (the window's path; the
    per-step path stays sound) fails the check."""
    from focnerf_tpu_torch.train import fused

    make = fused.make_fused_chunk

    def halving(step_fns, *a, **kw):
        def half(fn):
            def step(state, batch, occ, draws, hyper):
                n = batch["rays_o"].shape[0] // 2
                slab = draws["u"].shape[0] // batch["rays_o"].shape[0]
                batch = {k: (v[:n] if torch.is_tensor(v) and v.dim() and v.shape[0] == 2 * n else v)
                         for k, v in batch.items()}
                draws = {"bg": draws["bg"][:n], "noise": draws["noise"][:n], "u": draws["u"][:n * slab]}
                return fn(state, batch, occ, draws, hyper)
            return step
        return make([half(fn) for fn in step_fns], *a, **kw)

    monkeypatch.setattr(fused, "make_fused_chunk", halving)
    r = tiny.run_cell(checkout, "tiny.train-o-k16")
    assert not r["correct"], r["checks"]
    assert r["checks"]["loss_gap"]["value"] > tiny.LIMITS["train"]["loss_gap"]
    assert r["checks"]["end_update_gap"]["value"] > tiny.LIMITS["train"]["end_update_gap"]


def test_an_altered_answer_fails(checkout, monkeypatch):
    from focnerf_tpu_torch.train.trainer import Trainer

    render_view = Trainer._render_view

    def altered(self, *a, **kw):
        img, depth = render_view(self, *a, **kw)
        img = img.clone()
        img[: img.shape[0] // 4] += 0.05
        return img, depth

    monkeypatch.setattr(Trainer, "_render_view", altered)
    r = tiny.run_cell(checkout, "tiny.render-test-800")
    assert not r["correct"] and r["checks"]["image_p99_gap"]["value"] > tiny.LIMITS["render"]["image_p99_gap"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["ngp-object.train-o-k16", "ngp-object.render-test-800"])
def test_each_cell_runs_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, os.path.join(tiny.PORTBENCH, "run.py"), "--workload", cell, "--seed",
                          "2147483659", "--seconds", "3", "--trace", "0"], cwd=tiny.REPO, capture_output=True,
                         text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu", r
