"""CPU tests of the benchmark's yardstick: window arithmetic, work counts,
frozen inputs, the import rule, and the plain reference against the port
at tiny sizes."""

import ast
import math
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from portbench import scenes, tracing, work  # noqa: E402
from portbench.reference import nerf as ref  # noqa: E402

PORTBENCH = os.path.dirname(HERE)
CONFIG = {"bound": 2.0, "num_levels": 4, "level_dim": 2, "base_resolution": 4, "log2_hashmap_size": 12,
          "finest_resolution_per_bound": 2048, "num_layers": 2, "hidden_dim": 16, "geo_feat_dim": 15,
          "num_layers_color": 3, "hidden_dim_color": 16, "sh_degree": 4, "yolo_feats_dim": 144,
          "yolo_hidden_dim": 16, "yolo_encoding_dim": 16, "compute_dtype": "bfloat16", "stochastic_corners": 1,
          "stochastic_min_size": 1, "dt_gamma": 1 / 128, "max_steps": 1024, "min_near": 0.2, "density_thresh": 10.0,
          "mask_penalty": 1e-8, "lr": 1e-2, "iters": 30000}


# ---------------------------------------------------------------- the window's arithmetic
@pytest.mark.parametrize("spans, busy, idle", [
    ([(0, 10), (5, 20), (30, 40)], 30e-6, [(20, 30)]),
    ([(0, 10), (2, 3), (10, 12)], 12e-6, []),
    ([(5, 6)], 1e-6, []),
    ([], 0.0, []),
])
def test_union_and_gaps(spans, busy, idle):
    assert tracing.union_s(spans) == pytest.approx(busy)
    assert tracing.gaps(spans) == idle


def test_breakdown_names_ops_and_gaps():
    summary = {"device": [("k1", 0, 10), ("k2", 20, 25), ("k1", 40, 50)],
               "host": [("aten::outer", 0, 100), ("aten::inner", 15, 30)], "wall_s": 1e-4, "busy_s": 25e-6}
    b = tracing.breakdown(summary)
    assert b["device_ops"][0] == ["k1", pytest.approx(20e-6)]
    assert b["idle_gaps"][0] == ["aten::inner", pytest.approx(15e-6)]  # 25..40 begins inside both: the inner
    assert b["idle_gaps"][1] == ["aten::outer", pytest.approx(10e-6)]


# ---------------------------------------------------------------- work counts
def test_work_counts_of_the_object_field():
    import json

    with open(os.path.join(PORTBENCH, "configs", "ngp-object.json")) as f:
        c = json.load(f)
    assert work.macs_per_sample(c) == 32 * 64 + 64 * 16 + 47 * 64 + 64 * 64 + 64 * 3 == 10368
    assert work.forward_flops_per_sample(c) == 20736
    assert work.train_flops_per_sample(c) == 62208
    n = 4096 * 128
    assert work.encode_bytes(n, c) == n * (3 + 32) * 4
    assert work.table_grad_bytes(n, c) == n * (16 * 4 * 2 + 32 * 4)
    assert work.roofline_pct(3.35e12, 0.0, 2.0) == pytest.approx(50.0)
    assert work.roofline_pct(0.0, 989e12, 1.0) == pytest.approx(100.0)


# ---------------------------------------------------------------- frozen inputs
def test_hard_volume_is_frozen():
    a, b = scenes.hard_volume(24), scenes.hard_volume(24)
    assert np.array_equal(a, b) and a.shape == (24, 24, 24, 4)
    assert float(a[..., 3].sum()) == pytest.approx(60.0 * int((a[..., 3] > 0).sum()))
    assert 0.01 < float((a[..., 3] > 0).mean()) < 0.5


def test_scene_is_deterministic_and_kept(tmp_path):
    spec = {"name": "t", "H": 16, "W": 16, "n_train": 2, "n_val": 1, "n_test": 2, "gt_res": 24, "extent": 1.6,
            "radius": 4.0, "bound": 2.0}
    root = scenes.ensure_scene(spec, "cpu", str(tmp_path / "a"))
    again = scenes.ensure_scene(spec, "cpu", str(tmp_path / "b"))
    for split in ("train", "test"):
        x, y = scenes.load_arrays(root, split), scenes.load_arrays(again, split)
        assert np.array_equal(x["rgba"], y["rgba"]) and np.array_equal(x["poses"], y["poses"])
    assert x["rgba"][..., 3].max() > 127  # the object is in view
    assert np.array_equal(np.load(os.path.join(root, "occupancy.npy")), np.load(os.path.join(again, "occupancy.npy")))
    stamp = os.path.getmtime(os.path.join(root, "done.json"))
    assert scenes.ensure_scene(spec, "cpu", str(tmp_path / "a")) == root
    assert os.path.getmtime(os.path.join(root, "done.json")) == stamp


def test_provider_reads_the_frozen_poses(tmp_path):
    from focnerf_tpu_torch.data.provider import DatasetOptions, NeRFDataset

    spec = {"name": "p", "H": 16, "W": 16, "n_train": 2, "n_val": 1, "n_test": 3, "gt_res": 24, "extent": 1.6,
            "radius": 4.0, "bound": 2.0}
    root = scenes.ensure_scene(spec, "cpu", str(tmp_path))
    ds = NeRFDataset(DatasetOptions(path=root, scale=1.0), split="test", device="cpu")
    frozen = scenes.load_arrays(root, "test")
    assert np.array_equal(ds.poses, frozen["poses"])
    assert np.array_equal(ds.intrinsics, frozen["intrinsics"])
    assert np.allclose(ds.images.numpy(), frozen["rgba"].reshape(3, -1, 4) / 255.0, atol=1e-6)


# ---------------------------------------------------------------- what the benchmark imports
def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def _sources(*parts):
    for dirpath, _, files in os.walk(os.path.join(PORTBENCH, *parts)):
        yield from (os.path.join(dirpath, f) for f in files if f.endswith(".py"))


def test_no_jax_anywhere_and_no_program_in_the_reference():
    for path in _sources():
        assert not set(_imports(path)) & {"jax", "jaxlib", "flax", "focnerf_tpu"}, path
    for path in [*_sources("reference"), os.path.join(PORTBENCH, "scenes.py"), os.path.join(PORTBENCH, "work.py")]:
        assert "focnerf_tpu_torch" not in set(_imports(path)), path


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from portbench import harness

    monkeypatch.setitem(sys.modules, "focnerf_tpu_torch_like", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", object())
    assert harness.forbidden_modules() == ["jaxlib"]


# ---------------------------------------------------------------- the reference against the port
def _program_params(seed=3):
    from portbench import common

    return common.seeded_weights(CONFIG, seed, "cpu", 0.1)


def _program_cfg():
    from focnerf_tpu_torch.models.nerf import NeRFConfig

    from portbench import common

    return common.program_config(CONFIG, NeRFConfig(stochastic_corners=1, stochastic_min_size=1))


@pytest.mark.parametrize("stochastic", [False, True])
def test_encode_matches_the_port(stochastic):
    from focnerf_tpu_torch.ops.hashgrid import encode_plain

    cfg = _program_cfg()
    spec = cfg.grid_spec
    grid = ref.layout_of(CONFIG)
    assert grid.rows == spec.table_rows and list(grid.res) == list(spec.resolutions)
    g = torch.Generator().manual_seed(0)
    table = torch.rand((grid.rows, 2), generator=g) - 0.5
    x = torch.rand((500, 3), generator=g)
    u = torch.rand((500, 4, 1, 3), generator=g) if stochastic else None
    want, _, _ = encode_plain(table, x, spec, u, residuals=False)
    assert torch.allclose(ref.encode(table, x, grid, u), want, atol=1e-6)


def test_field_matches_the_port():
    from focnerf_tpu_torch.models import nerf

    params, cfg = _program_params(), _program_cfg()
    grid = ref.layout_of(CONFIG)
    g = torch.Generator().manual_seed(1)
    xyz = (torch.rand((300, 3), generator=g) * 2 - 1) * 1.5
    d = torch.nn.functional.normalize(torch.randn((300, 3), generator=g), dim=-1)
    feat = torch.rand((144,), generator=g)
    sig, geo = ref.density(params, CONFIG, grid, xyz, torch.bfloat16)
    psig, pgeo = nerf.density_fn(params, cfg, xyz)
    assert torch.allclose(sig, psig, rtol=1e-5) and torch.allclose(geo, pgeo, atol=1e-6)
    enc = ref.object_encoding(params, feat, torch.bfloat16)
    rgb = ref.color(params, d, geo, enc, torch.bfloat16)
    prgb = nerf.color_fn(params, cfg, d, pgeo, nerf.encode_objfeat(params, cfg, feat))
    assert torch.allclose(rgb, prgb, atol=1e-6)


def test_composite_matches_the_port():
    from focnerf_tpu_torch.ops.composite import composite_rays

    g = torch.Generator().manual_seed(2)
    sig, rgb = torch.rand((64, 32), generator=g) * 30, torch.rand((64, 32, 3), generator=g)
    dts, ts = torch.rand((64, 32), generator=g) * 0.05, torch.cumsum(torch.rand((64, 32), generator=g), -1)
    bg = torch.rand((64, 3), generator=g)
    image, wsum, depth = ref.composite(sig, rgb, dts, ts, bg)
    want = composite_rays(sig, rgb, dts, ts, bg_color=bg, T_thresh=1e-4)
    assert torch.allclose(image, want["image"], atol=1e-6) and torch.allclose(depth, want["depth"], atol=1e-5)


@pytest.mark.parametrize("skip", [False, True])
def test_march_matches_the_port(skip):
    from focnerf_tpu_torch.core.rays import get_rays
    from focnerf_tpu_torch.ops.marching import march_rays, march_skip_plain
    from focnerf_tpu_torch.ops.occupancy import occupancy_skip_field

    g = torch.Generator().manual_seed(4)
    bits = torch.rand((2, 128**3), generator=g) < 0.02
    bits[0].view(128, 128, 128)[40:90, 50:80, 30:100] = True
    pose = torch.from_numpy(scenes.orbit_poses(1, 4.0)[0])
    rays = get_rays(pose, [30.0, 30.0, 16.0, 16.0], 32, 32)
    o, d = rays["rays_o"], rays["rays_d"]
    near, far = ref.near_far(o.double(), d.double(), 2.0, 0.2)
    noise = torch.rand((o.shape[0],), generator=g) if skip else None
    ts, dts, valid = ref.march(o, d, near, far, bits, bound=2.0, dt_gamma=1 / 128, max_steps=1024, slab=64,
                               noise=noise)
    kw = dict(bound=2.0, dt_gamma=1 / 128, max_steps=1024, slab=64, noise=noise)
    if skip:
        m = march_skip_plain(o, d, near.float(), far.float(), occupancy_skip_field(bits), **kw)
    else:
        m = march_rays(o, d, near.float(), far.float(), bits, **kw)
    assert valid.sum() > 1000
    same = (valid == m.valid).all(-1)
    assert float(same.float().mean()) > 0.97  # a lattice point on a cell face may fall either way
    assert torch.allclose(ts[same].float(), m.ts[same], rtol=1e-5, atol=1e-6)


def test_first_occupancy_matches_the_port():
    from focnerf_tpu_torch.models import nerf
    from focnerf_tpu_torch.ops.occupancy import (init_occupancy, mark_untrained_grid, occupancy_bitfield,
                                                 occupancy_draws, update_occupancy)

    params, cfg = _program_params(), _program_cfg()
    poses = torch.from_numpy(scenes.orbit_poses(4, 4.0))
    intr = np.array([30.0, 30.0, 16.0, 16.0], np.float32)
    draws = occupancy_draws(torch.Generator().manual_seed(5), 2, True, "cpu")
    occ = mark_untrained_grid(init_occupancy(2.0, "cpu"), poses.numpy(), intr, bound=2.0)
    occ = update_occupancy(occ, lambda x: nerf.density_fn(params, cfg, x)[0], draws, bound=2.0)
    dens, bits = ref.first_occupancy(params, CONFIG, ref.layout_of(CONFIG), poses, intr, draws["jitter"],
                                     torch.bfloat16)
    assert torch.equal(dens < 0, occ.density_grid < 0)
    assert torch.allclose(dens, occ.density_grid, rtol=1e-5)
    assert float((bits != occupancy_bitfield(occ, 10.0)).float().mean()) < 1e-4


def test_adam_matches_the_port():
    from focnerf_tpu_torch.train.state import TrainState, param_leaves

    params = _program_params()
    state = TrainState(params, lr=1e-2, iters=30000)
    mine = ref.clone(params, requires_grad=True)
    adam = ref.Adam(mine, 1e-2, 30000)
    g = torch.Generator().manual_seed(6)
    for _ in range(3):
        grads = [torch.randn(p.shape, generator=g) * 1e-3 for p in param_leaves(state.params)]
        for p, q, gr in zip(param_leaves(state.params), ref.leaves(mine), grads):
            p.grad, q.grad = gr.clone(), gr.clone()
        state.apply_gradients()
        adam.step()
    for p, q in zip(param_leaves(state.params), ref.leaves(mine)):
        assert torch.allclose(p, q, atol=1e-7)
    assert math.isclose(float(state.optimizer.state[param_leaves(state.params)[0]]["step"]), 3.0)
