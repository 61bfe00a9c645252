"""The viewer (viewer/server.py, apps/viewer_app.py, core/camera.OrbitCamera)
on the CPU, held against the JAX package's:

  - ``ViewerState``: the same numpy render function gives the same frames,
    downscales, intrinsics and ``spp`` sequence in both packages; every case
    of JAX's TestViewer/TestViewerControls (tests/test_misc_utils.py) on the
    port: dynamic resolution, SPP accumulation, the HTTP endpoints, control
    settings reaching the render function, a settings change resetting SPP,
    actions with a 5-argument render function, pause; ``/render`` with PIL
    blocked;
  - ``_view_only`` per workspace kind, the port's frame against JAX's on the
    same workspace (a hash checkpoint converted by tools/jax_ckpt_to_torch,
    a D-NeRF checkpoint carried across with ``interop``, a baked volume and a
    K-planes field in the npz both packages read), each with its tolerance;
    the ``--baked`` cache of a hash checkpoint; the newest dynamic field;
  - train-while-viewing: steps, renders and actions under one lock, and
    ``main``'s view-only fallback.
"""

import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))
from helpers import make_synthetic_scene  # noqa: E402
from test_torch_baked import blob_volume  # noqa: E402
from test_torch_compose import sphere_bits  # noqa: E402
from test_torch_dnerf import configs as dnerf_configs  # noqa: E402  (also starts torch's pool first)
from test_torch_dnerf import make_dnerf_params  # noqa: E402
from test_torch_render import _jax_workspace  # noqa: E402

from focnerf_tpu.apps import viewer_app as jva  # noqa: E402
from focnerf_tpu.config import parse_options as jparse  # noqa: E402
from focnerf_tpu.core.camera import OrbitCamera as JOrbitCamera  # noqa: E402
from focnerf_tpu.viewer import server as jserver  # noqa: E402
from focnerf_tpu_torch import interop  # noqa: E402
from focnerf_tpu_torch.apps import viewer_app as tva  # noqa: E402
from focnerf_tpu_torch.config import parse_options as tparse  # noqa: E402
from focnerf_tpu_torch.core.camera import OrbitCamera, rand_poses  # noqa: E402
from focnerf_tpu_torch.data.png import decode_png  # noqa: E402
from focnerf_tpu_torch.viewer import server as tserver  # noqa: E402

CAM = {"theta": 0.5, "phi": 0.2, "radius": 2.0}
HW = 24
INTR = (1.2 * HW, 1.2 * HW, HW / 2, HW / 2)


def _post(port, path, obj):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode())
    return urllib.request.urlopen(req, timeout=30).read()


def _get(port, path):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30).read()


class Served:
    """A ViewerState served on an ephemeral 127.0.0.1 port; on exit the
    server is shut down and both its thread and the state's are joined."""

    def __init__(self, state):
        self.state = state
        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), tserver.make_handler(state))
        self.port = self.srv.server_address[1]
        self.thread = threading.Thread(target=self.srv.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(10)
        assert not self.thread.is_alive()
        assert self.state.stop(timeout=30)


# ---------------------------------------------------------------- ViewerState
def _recording_fn(calls, six=False):
    """A deterministic render function: the frame's value depends on the
    call count, the intrinsics and the pose, so every input shows."""
    def frame(pose, intr, H, W, t):
        calls.append((H, W, tuple(float(v) for v in intr), float(t)))
        v = (len(calls) * 0.07 + float(intr[2]) * 0.01 + float(pose[0, 3]) * 0.1) % 1.0
        return np.full((H, W, 3), v, np.float32) + np.linspace(0, 0.1, W, dtype=np.float32)[None, :, None]

    if six:
        return lambda pose, intr, H, W, t, settings=None: frame(pose, intr, H, W, t)
    return frame


@pytest.mark.parametrize("six", [False, True], ids=["5-arg", "6-arg"])
def test_viewer_state_matches_jax(six):
    """Frames, render calls (size, intrinsics with the SPP jitter, time),
    downscale and spp after every step of the same camera script."""
    script = [CAM] * 6 + [dict(CAM, theta=0.9)] + [dict(CAM, theta=0.9, t=0.5)] * 3
    out = {}
    for name, mod in (("jax", jserver), ("torch", tserver)):
        calls = []
        vs = mod.ViewerState(_recording_fn(calls, six), W=32, H=32, frame_budget_ms=1e9, max_spp=4)
        frames = [(vs.render(c), vs.downscale, vs.spp) for c in script]
        vs.settings["bg"] = 0.0
        vs._settings_version += 1
        frames.append((vs.render(script[-1]), vs.downscale, vs.spp))
        out[name] = (frames, calls)
    (jf, jc), (tf, tc) = out["jax"], out["torch"]
    assert tc == jc
    for (a, da, sa), (b, db, sb) in zip(jf, tf):
        assert (da, sa) == (db, sb)
        np.testing.assert_array_equal(a, b)


def test_render_and_dynamic_resolution():
    calls = []

    def render_fn(pose, intr, H, W, t):
        calls.append((H, W))
        assert pose.shape == (4, 4)
        return np.zeros((H, W, 3), np.float32)

    vs = tserver.ViewerState(render_fn, W=64, H=64, frame_budget_ms=1e9)
    img = vs.render(CAM)
    assert img.shape == (16, 16, 3)
    for _ in range(5):  # instant renders: the downscale falls to 1
        vs.render(CAM)
    assert vs.downscale == 1 and calls[-1] == (64, 64)
    slow = tserver.ViewerState(lambda p, i, H, W, t: time.sleep(0.03) or np.zeros((H, W, 3)), W=64, H=64,
                               frame_budget_ms=1.0)
    slow.downscale = 1
    slow.render(CAM)  # over budget: the downscale rises
    assert slow.downscale == 2


def test_spp_accumulation():
    """Still camera -> jittered passes are averaged up to max_spp; camera
    motion resets the accumulator (ref gui.py:142-148)."""
    vals = iter(np.linspace(0.0, 1.0, 32))
    vs = tserver.ViewerState(lambda p, i, H, W, t: np.full((H, W, 3), next(vals), np.float32), W=16, H=16,
                             frame_budget_ms=1e9, max_spp=4)
    vs.downscale = 1
    f1 = vs.render(CAM)
    assert vs.spp == 1
    f2 = vs.render(CAM)
    assert vs.spp == 2 and f2[0, 0, 0] != f1[0, 0, 0]
    np.testing.assert_allclose(f2[0, 0, 0], (0.0 + np.linspace(0, 1, 32)[1]) / 2, atol=1e-6)
    vs.render(CAM)
    vs.render(CAM)
    assert vs.spp == 4
    before = vs.render(CAM)  # capped: no new pass, the cached average
    assert vs.spp == 4
    np.testing.assert_array_equal(before, vs.render(CAM))
    vs.render(dict(CAM, theta=0.9))  # moved: reset
    assert vs.spp == 1


def test_http_endpoints():
    vs = tserver.ViewerState(lambda p, i, H, W, t: np.zeros((H, W, 3)), W=32, H=32)
    with Served(vs) as s:
        assert b"canvas" in _get(s.port, "/")
        png = _post(s.port, "/render", {"theta": 0.1, "phi": 0.1, "radius": 2.0})
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        assert decode_png(png).shape == (8, 8, 3)
        status = json.loads(_get(s.port, "/status"))
        assert sorted(status) == ["downscale", "loss", "max_spp", "spp", "training"]
        assert status["training"] is False and status["spp"] == 1 and status["max_spp"] == 16
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(s.port, "/nope")
        assert e.value.code == 404


def test_control_settings_reach_render_fn():
    seen = {}

    def render_fn(pose, intr, H, W, t, settings=None):
        seen.update(settings or {})
        seen["focal"] = intr[0]
        return np.zeros((H, W, 3), np.float32)

    vs = tserver.ViewerState(render_fn, W=32, H=32, frame_budget_ms=1e9)
    with Served(vs) as s:
        out = json.loads(_post(s.port, "/control", {
            "fovy": 90.0, "bg": 0.0, "dt_gamma": 0.01, "max_steps": 256, "aabb": [-1, -1, -1, 1, 1, 1],
            "max_spp": 3}))
        assert out == {"fovy": 90.0, "bg": 0.0, "dt_gamma": 0.01, "max_steps": 256,
                       "aabb": [-1, -1, -1, 1, 1, 1], "max_spp": 3, "paused": False}
        _post(s.port, "/render", {"theta": 0.1, "phi": 0.1, "radius": 2.0})
    assert seen["bg"] == 0.0 and seen["dt_gamma"] == 0.01 and seen["max_steps"] == 256
    assert seen["aabb"] == [-1, -1, -1, 1, 1, 1]
    assert vs.max_spp == 3
    assert abs(seen["focal"] - 8 / 2) < 1e-3  # fovy 90 at H = 8 (downscale 4): focal H / 2


def test_settings_change_resets_spp():
    vs = tserver.ViewerState(lambda p, i, H, W, t, settings=None: np.zeros((H, W, 3), np.float32), W=16, H=16,
                             frame_budget_ms=1e9)
    vs.downscale = 1  # pin the resolution so only the settings can reset spp
    vs.render(CAM)
    vs.render(CAM)
    assert vs.spp == 2
    vs.settings["bg"] = 0.0
    vs._settings_version += 1  # what /control does
    vs.render(CAM)
    assert vs.spp == 1


def test_actions_and_legacy_render_fn():
    fired = []
    vs = tserver.ViewerState(lambda p, i, H, W, t: np.zeros((H, W, 3)), W=16, H=16,
                             actions={"save_mesh": lambda: fired.append(1) or "mesh ok",
                                      "boom": lambda: 1 / 0})
    with Served(vs) as s:
        assert json.loads(_post(s.port, "/action", {"name": "save_mesh"}))["result"] == "mesh ok"
        assert fired == [1]
        assert _post(s.port, "/render", {"theta": 0.1, "phi": 0.1, "radius": 2.0})[:4] == b"\x89PNG"
        for name, code in (("nope", 404), ("boom", 500)):  # the server stays alive
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(s.port, "/action", {"name": name})
            assert e.value.code == code
        assert _post(s.port, "/render", {"theta": 0.1, "phi": 0.1, "radius": 2.0})[:4] == b"\x89PNG"


def test_pause_stops_training_bursts():
    steps = []
    vs = tserver.ViewerState(lambda p, i, H, W, t: np.zeros((H, W, 3)), W=16, H=16,
                             train_fn=lambda: steps.append(1) or 0.0)
    try:
        deadline = time.time() + 10
        while not steps and time.time() < deadline:
            time.sleep(0.01)
        assert steps, "train loop never ran"
        vs.paused = True
        time.sleep(0.3)  # the burst under way ends
        n = len(steps)
        assert n % 16 == 0  # whole bursts
        time.sleep(0.3)
        assert len(steps) == n, "train loop kept stepping while paused"
    finally:
        assert vs.stop(timeout=10)


def test_render_png_without_pil(monkeypatch):
    """``/render`` encodes with data/png.py: with PIL unimportable the frame
    still arrives and decodes to the rendered values within 1/255."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError):
        import PIL  # noqa: F401
    rng = np.random.default_rng(0)
    frame = rng.uniform(size=(8, 8, 3)).astype(np.float32)
    vs = tserver.ViewerState(lambda p, i, H, W, t: frame, W=32, H=32, frame_budget_ms=1e9)
    with Served(vs) as s:
        png = _post(s.port, "/render", CAM)
    got = decode_png(png).astype(np.float32) / 255.0
    assert got.shape == (8, 8, 3)
    assert np.abs(got - frame).max() <= 1 / 255 + 1e-7


def test_orbit_camera_matches_jax():
    cams = [OrbitCamera(64, 48, r=2.5, fovy=50.0), JOrbitCamera(64, 48, r=2.5, fovy=50.0)]
    for cam in cams:
        cam.orbit(30.0, -12.0)
        cam.scale(1.5)
        cam.pan(40.0, -20.0, 5.0)
        cam.orbit(-7.0, 3.0)
    np.testing.assert_array_equal(cams[0].pose, cams[1].pose)
    np.testing.assert_array_equal(cams[0].intrinsics, cams[1].intrinsics)
    assert cams[0].pose.dtype == np.float32 and not np.allclose(cams[0].pose, np.eye(4))


# ---------------------------------------------------------------- _view_only
def _pose(radius=2.5, seed=3):
    return rand_poses(np.random.default_rng(seed), 1, radius=radius)[0]


def _frames(argv_j, argv_t, times=(0.0,), jit=True):
    """JAX's and the port's ``_view_only`` frames of the same camera at ``times``."""
    jfn, jtrain = jva._view_only(jparse(argv_j))
    tfn, ttrain = tva._view_only(tparse(argv_t), "cpu")
    assert jtrain is None and ttrain is None
    pose = _pose()
    out = []
    for t in times:
        if jit:
            want = np.asarray(jfn(pose, INTR, HW, HW, t))
        else:
            with jax.disable_jit():
                want = np.asarray(jfn(pose, INTR, HW, HW, t))
        got = tfn(pose, INTR, HW, HW, t)
        assert isinstance(got, np.ndarray) and got.shape == want.shape == (HW, HW, 3)
        out.append((got, want))
    return out


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_synthetic_scene(str(tmp_path_factory.mktemp("viewer") / "scene"), n_train=3, n_val=1)


HASH_ARGS = ["--cuda_ray", "--scale", "1.0", "--bound", "1.0", "--grid_levels", "4", "--max_ray_batch", "256"]


@pytest.fixture(scope="module")
def hash_workspaces(scene, tmp_path_factory):
    """A JAX object workspace (orbax checkpoint, a sphere occupancy grid) and
    the port's, converted by tools/jax_ckpt_to_torch.py."""
    from jax_ckpt_to_torch import convert

    root = tmp_path_factory.mktemp("hashws")
    wsj, wst = str(root / "wsj"), str(root / "wst")
    ckpt = _jax_workspace(scene, wsj, [scene, "--workspace", wsj] + HASH_ARGS)
    assert convert(ckpt, os.path.join(f"{wst}_background", "checkpoints")) == 7
    return f"{wsj}_background", f"{wst}_background"


def test_view_only_hash_checkpoint_matches_jax(scene, hash_workspaces):
    wsj, wst = hash_workspaces
    (got, want), = _frames([scene, "--workspace", wsj, "--test"] + HASH_ARGS,
                           [scene, "--workspace", wst, "--test"] + HASH_ARGS)
    assert 0.02 < float((1.0 - want).mean()) < 0.98  # the object is in view
    # fp32, the occupancy march on both sides (tests/test_torch_render.py's bar)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_view_only_baked_hash_checkpoint_cache(scene, hash_workspaces, capsys, monkeypatch):
    """``--baked``: the first view bakes, writes the cache and calls the bake
    gate as JAX's viewer does (3 probe poses, 200x200, its report path); the
    next loads the cache (not older than the checkpoint) and serves the same
    frame; asked for uint8 it converts the cache, and then asked for fp16 it
    re-bakes. (The gate itself: tests/test_torch_bake_gate.py.)"""
    from focnerf_tpu_torch.render import bake_gate

    gated = []

    def gate(params, cfg, vol, poses, intrinsics, H, W, **kw):
        gated.append((np.asarray(poses).shape, tuple(intrinsics), H, W, kw["num_steps"], kw["out_path"]))
        return {"psnr_baked_vs_exact_mean": 30.0}

    monkeypatch.setattr(bake_gate, "bake_quality_report", gate)
    _, wst = hash_workspaces
    argv = [scene, "--workspace", wst, "--test", "--baked", "--bake_res", "16", "--num_steps", "32"] + HASH_ARGS
    pose = _pose()
    fn, _ = tva._view_only(tparse(argv), "cpu")
    first = fn(pose, INTR, HW, HW, 0.0)
    out = capsys.readouterr().out
    assert "baked 16^3 volume" in out and "[bake-gate] baked-vs-exact 30.0 dB mean" in out
    assert os.path.exists(os.path.join(wst, "baked_16_sh0.npz"))
    assert gated == [((3, 4, 4), (1.1 * 200, 1.1 * 200, 100.0, 100.0), 200, 200, 32,
                      os.path.join(wst, "bake_quality.json"))]
    fn, _ = tva._view_only(tparse(argv), "cpu")
    cached = fn(pose, INTR, HW, HW, 0.0)
    assert "loaded baked volume cache" in capsys.readouterr().out
    np.testing.assert_allclose(cached, first, atol=2e-3)  # the cache stores fp16
    fn, _ = tva._view_only(tparse(argv + ["--bake_quantize"]), "cpu")
    assert "re-saved cache as uint8" in capsys.readouterr().out
    assert np.abs(fn(pose, INTR, HW, HW, 0.0) - first).max() < 0.05  # uint8 storage
    tva._view_only(tparse(argv + ["--no-bake_gate"]), "cpu")
    assert "quantized cache + fp16 requested: re-baking" in capsys.readouterr().out
    assert len(gated) == 1
    assert np.isfinite(first).all() and float((1.0 - first).mean()) > 0.02


@pytest.fixture(scope="module")
def dnerf_workspaces(tmp_path_factory):
    """A D-NeRF checkpoint (deform, tiny) with a two-slot time grid (a ball
    left of the centre at t < 0.5, right of it after), written by the JAX
    package (orbax) and, carried across with ``interop``, by the port."""
    from focnerf_tpu.render.dnerf_renderer import TimeOccupancyState as JTimeOcc
    from focnerf_tpu.train import checkpoints as jck
    from focnerf_tpu.train.state import create_train_state, make_optimizer
    from focnerf_tpu_torch.train import checkpoints as tck

    root = tmp_path_factory.mktemp("dnerfws")
    jcfg, tcfg = dnerf_configs("deform")
    jp = make_dnerf_params(jcfg, seed=2)
    grid = np.stack([np.where(sphere_bits((x, 0.0, 0.0), 0.5, gs=128), 20.0, 0.0) for x in (-0.3, 0.3)])
    grid = grid.astype(np.float32)
    state = create_train_state(jax.random.key(0), jcfg, make_optimizer(), params=jax.tree.map(jnp.asarray, jp))
    jdir = str(root / "wsj" / "checkpoints")
    mgr = jck.CheckpointManager(jdir)
    mgr.save(state, JTimeOcc(jnp.asarray(grid), jnp.asarray(grid.mean()), jnp.asarray(2, jnp.int32)))
    mgr.close()
    jck.save_model_config(jdir, jcfg)
    tdir = str(root / "wst" / "checkpoints")
    tp = interop.dnerf_params_from_jax(jp, tcfg, "cpu")
    occ = interop.time_occupancy_from_jax({"density_grid": grid, "mean_density": grid.mean(), "iter_density": 2},
                                          1.0, 2, "cpu")
    tck.save_model_config(tdir, tcfg)
    tck.CheckpointManager(tdir).save({"step": 3, "params": tp, "ema_params": tp}, occ)
    return str(root / "wsj"), str(root / "wst")


def test_view_only_dnerf_matches_jax(scene, dnerf_workspaces):
    wsj, wst = dnerf_workspaces
    common = ["--test", "--cuda_ray", "--scale", "1.0", "--bound", "1.0", "--max_ray_batch", "256"]
    frames = _frames([scene, "--workspace", wsj] + common, [scene, "--workspace", wst] + common, times=(0.0, 1.0))
    for got, want in frames:
        assert 0.02 < float((1.0 - want).mean()) < 0.98
        # fp32 through the slot's march; the warped points come out of an
        # MLP (tests/test_torch_dnerf_renderer.py holds rays at 1e-5)
        np.testing.assert_allclose(got, want, atol=2e-5)
    assert np.abs(frames[0][0] - frames[1][0]).max() > 0.05  # the slider moves the ball


@pytest.fixture(scope="module")
def voxel_workspace(tmp_path_factory):
    """A voxel-trained workspace: main_voxel's baked npz (JAX's
    save_volume) and a K-planes field (JAX's save_kplanes_field); no
    checkpoint."""
    from focnerf_tpu.render import baked as jb
    from focnerf_tpu.train import voxel_kplanes as jkp

    ws = tmp_path_factory.mktemp("voxelws")
    jb.save_volume(str(ws / "baked_16_sh0.npz"), jb.BakedVolume(rgba=jnp.asarray(blob_volume(16)), bound=1.0))
    kp = jkp.init_kplanes_field(16, rank=2, time_res=4, rng=jax.random.key(5), init_scale=0.3, w0=0.5)
    jkp.save_kplanes_field(str(ws / "kplanes_16_sh0.npz"), kp, 1.0, 0)
    return str(ws)


@pytest.mark.parametrize("quantize", [False, True], ids=["fp16", "uint8-resident"])
def test_view_only_voxel_volume_matches_jax(scene, voxel_workspace, tmp_path, quantize):
    import shutil

    ws = str(tmp_path / "vx")
    os.makedirs(ws)
    shutil.copy(os.path.join(voxel_workspace, "baked_16_sh0.npz"), ws)
    argv = [scene, "--workspace", ws, "--test", "--baked", "--bake_res", "16", "--scale", "1.0", "--bound", "1.0"]
    argv += ["--bake_quantize"] if quantize else []
    (got, want), = _frames(argv, argv, jit=False)
    assert 0.02 < float((1.0 - want).mean()) < 0.98
    # fp32 shear-warp against eager JAX (tests/test_torch_baked.py's ATOL)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_view_only_kplanes_matches_jax(scene, voxel_workspace, tmp_path):
    import shutil

    ws = str(tmp_path / "kp")
    os.makedirs(ws)
    shutil.copy(os.path.join(voxel_workspace, "kplanes_16_sh0.npz"), ws)
    argv = [scene, "--workspace", ws, "--test", "--baked", "--bake_res", "16", "--scale", "1.0", "--bound", "1.0"]
    frames = _frames(argv, argv, times=(0.0, 0.5), jit=False)
    for got, want in frames:
        # the collapse (fp32 einsums, tests/test_torch_voxel_kplanes.py) then
        # the fp32 shear-warp against eager JAX
        np.testing.assert_allclose(got, want, atol=2e-5)
    assert np.abs(frames[0][0] - frames[1][0]).max() > 1e-3  # the slider moves the field


def test_view_only_serves_the_newest_dynamic_field(scene, voxel_workspace, tmp_path, capsys):
    """Both a dynvoxel and a K-planes cache: the newer file is served, in
    either order; a camera inside the volume gets a flat frame."""
    import shutil

    from focnerf_tpu_torch.train.voxel_dynamic import init_dyn_voxel_field, save_dyn_field

    ws = str(tmp_path / "dyn")
    os.makedirs(ws)
    kp = os.path.join(ws, "kplanes_16_sh0.npz")
    dyn = os.path.join(ws, "dynvoxel_16_sh0.npz")
    shutil.copy(os.path.join(voxel_workspace, "kplanes_16_sh0.npz"), kp)
    save_dyn_field(dyn, init_dyn_voxel_field(16, rank=2, time_slots=4, generator=torch.Generator().manual_seed(0),
                                             device="cpu"), 1.0, 0)
    argv = [scene, "--workspace", ws, "--test", "--baked", "--bake_res", "16", "--scale", "1.0", "--bound", "1.0"]
    for newer, older in ((kp, dyn), (dyn, kp)):
        os.utime(older, (1e9, 1e9))
        os.utime(newer, (2e9, 2e9))
        fn, _ = tva._view_only(tparse(argv), "cpu")
        assert f"[viewer] loaded dynamic voxel field {newer}" in capsys.readouterr().out
        inside = np.eye(4, dtype=np.float32)
        np.testing.assert_array_equal(fn(inside, INTR, HW, HW, 0.2), np.ones((HW, HW, 3), np.float32))


# ---------------------------------------------------------------- training
def test_train_while_viewing_under_one_lock(tmp_path, monkeypatch):
    """``_train_while_viewing`` behind the server: two bursts of steps from
    the burst thread while frames are served, no render overlapping a step
    (one lock), a finite float loss, save_ckpt writing a checkpoint, and no
    step after the pause."""
    from focnerf_tpu_torch.render import renderer
    from focnerf_tpu_torch.train.trainer import Trainer

    spans = []  # (what, start, end) of every train step and render

    def timed(what, fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spans.append((what, t0, time.perf_counter()))
        return wrapper

    from focnerf_tpu_torch.data.yolo_sidecar import preprocess_scene

    monkeypatch.setattr(Trainer, "train_step_once", timed("step", Trainer.train_step_once))
    monkeypatch.setattr(renderer, "render_image", timed("render", renderer.render_image))
    scene = make_synthetic_scene(str(tmp_path / "scene"), n_train=2, n_val=1)
    preprocess_scene(scene, disable_yolo=True)  # the sidecar a main_nerf run leaves
    argv = [scene, "--workspace", str(tmp_path / "ws"), "--cuda_ray", "--scale", "1.0", "--bound", "1.0",
            "--grid_levels", "4", "--num_rays", "64", "--max_ray_batch", "256"]
    render_fn, train_fn, actions = tva._train_while_viewing(tparse(argv), "cpu")
    assert sorted(actions) == ["save_ckpt", "save_mesh"]
    losses = []

    def step():
        losses.append(train_fn())
        if len(losses) == 32:
            vs.paused = True  # takes effect at the end of the second burst
        return losses[-1]

    vs = tserver.ViewerState(render_fn, W=32, H=32, train_fn=step, frame_budget_ms=1e9, actions=actions)
    with Served(vs) as s:
        deadline = time.time() + 120
        while len(losses) < 32 and time.time() < deadline:
            assert vs._thread.is_alive(), "the burst thread died"
            assert decode_png(_post(s.port, "/render", CAM)).shape[-1] == 3
        assert len(losses) == 32
        assert json.loads(_post(s.port, "/action", {"name": "save_ckpt"}))["result"] == "checkpoint saved @ step 32"
        time.sleep(0.5)
        assert len(losses) == 32, "stepped while paused"
        assert json.loads(_get(s.port, "/status"))["training"] is True
    assert all(isinstance(v, float) and np.isfinite(v) for v in losses)
    assert "ckpt_00000032.pt" in os.listdir(os.path.join(str(tmp_path / "ws") + "_background", "checkpoints"))
    steps = [sp for sp in spans if sp[0] == "step"]
    renders = [sp for sp in spans if sp[0] == "render"]
    assert len(steps) == 32 and renders
    for _, r0, r1 in renders:
        assert all(r1 <= s0 or s1 <= r0 for _, s0, s1 in steps), "a render overlapped a train step"


def test_fair_lock_serves_a_waiting_render_before_the_next_step():
    """The train-while-viewing lock goes to the thread that asked first: a
    render waiting while a step holds it runs before the step that the
    burst thread asks for right after releasing it."""
    lock, order = tva._FairLock(), []

    def render():
        with lock:
            order.append("render")

    with lock:
        t = threading.Thread(target=render)
        t.start()
        deadline = time.time() + 30
        while lock._next < 2 and time.time() < deadline:  # the render holds a ticket
            time.sleep(0.001)
    with lock:
        order.append("step")
    t.join(30)
    assert order == ["render", "step"]


def test_main_falls_back_to_view_only(scene, hash_workspaces, tmp_path, monkeypatch, capsys):
    """Without --test and without a trainable scene, ``main`` says so and
    serves the workspace view-only, as JAX's does; ``VIEWER_PORT`` reaches
    ``run_viewer``."""
    served = {}
    monkeypatch.setattr(tserver, "run_viewer", lambda state, port: served.update(state=state, port=port))
    monkeypatch.setenv("VIEWER_PORT", "0")
    _, wst = hash_workspaces
    empty = str(tmp_path / "no_scene")
    os.makedirs(empty)
    tva.main([empty, "--workspace", wst, "--W", "96", "--H", "64"] + HASH_ARGS, device="cpu")
    assert "no trainable scene" in capsys.readouterr().out
    state = served["state"]
    assert served["port"] == 0 and not state.training and (state.W, state.H) == (48, 32)
    assert state.render(CAM).shape == (8, 12, 3)
