"""Interactive web viewer: orbit camera, progressive rendering, live training.

Twin of focnerf_tpu/viewer/server.py (the dearpygui GUI of nerf/gui.py as a
headless web server), with the standard library and numpy only:

  - dynamic resolution targeting a frame budget (ref gui.py:134-140: 200 ms
    budget, downscale floor 1/4);
  - train-while-viewing in 16-step bursts on a worker thread (ref
    gui.py:89-111);
  - progressive SPP accumulation while the camera is still, with the
    principal point jittered by ``np.random.default_rng(spp)`` (ref
    gui.py:142-148);
  - a time slider for D-NeRF and dynamic voxel fields;
  - the control surface: ``/control`` (fovy, bg, dt_gamma, max_steps,
    max_spp, aabb, paused), ``/action`` (save_ckpt, save_mesh when a trainer
    is attached), ``/status`` and ``/render``, with JAX's JSON.

Frames travel as PNG, encoded by ``data/png.encode_png`` (stdlib zlib and
numpy) on every machine: the card's machine has no PIL. ``run_viewer``
prints the port it bound (``port=0`` asks the system for a free one).
"""

from __future__ import annotations

import inspect
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from focnerf_tpu_torch.data.png import encode_png

_PAGE = """<!DOCTYPE html>
<html><head><title>focnerf-tpu viewer</title><style>
body{margin:0;background:#111;color:#ddd;font-family:monospace}
#hud{position:fixed;top:8px;left:8px;background:#0008;padding:6px}
canvas{display:block;margin:auto;image-rendering:pixelated}
</style></head><body>
<div id="hud">drag: orbit | wheel: zoom | shift-drag: pan | t: time+ | fps <span id="fps">-</span>
<br>fovy <input id="fovy" type="range" min="20" max="120" value="50" step="1">
bg <select id="bg"><option value="1">white</option><option value="0">black</option></select>
time <input id="tsl" type="range" min="0" max="1" value="0" step="0.01">
<br>dt_gamma <input id="dtg" type="range" min="0" max="0.06" value="0" step="0.001">
max_steps <input id="mst" type="range" min="64" max="1024" value="1024" step="64">
spp <input id="spp" type="range" min="1" max="64" value="16" step="1">
<br>aabb <input id="aabb" size="22" placeholder="-1,-1,-1,1,1,1">
<span id="trainctl" style="display:none"><label><input id="pause" type="checkbox">pause train</label>
<button id="ckptb">save ckpt</button><button id="meshb">save mesh</button></span>
<span id="msg"></span></div>
<canvas id="c" width="512" height="512"></canvas>
<script>
const c = document.getElementById('c'), ctx = c.getContext('2d');
let theta = 1.2, phi = 0.4, radius = 2.5, cx=0, cy=0, cz=0, t=0.0, busy=false, dirty=true;
let drag=false, panning=false, lx=0, ly=0;
c.onmousedown = e=>{drag=true; panning=e.shiftKey; lx=e.clientX; ly=e.clientY};
window.onmouseup = ()=>drag=false;
window.onmousemove = e=>{ if(!drag) return;
  const dx=e.clientX-lx, dy=e.clientY-ly; lx=e.clientX; ly=e.clientY;
  if(panning){cx -= dx*0.003; cy += dy*0.003;} else {theta -= dx*0.01; phi = Math.min(1.5, Math.max(-1.5, phi + dy*0.01));}
  dirty=true; };
c.onwheel = e=>{ radius *= Math.pow(1.1, e.deltaY>0?1:-1); dirty=true; e.preventDefault(); };
window.onkeydown = e=>{ if(e.key=='t'){ t = (t + 0.05) % 1.0; document.getElementById('tsl').value=t; dirty=true; } };
function ctl(k, v){ fetch('/control', {method:'POST', body: JSON.stringify({[k]: v})}).then(()=>dirty=true); }
document.getElementById('fovy').oninput = e=>ctl('fovy', +e.target.value);
document.getElementById('bg').onchange = e=>ctl('bg', +e.target.value);
document.getElementById('tsl').oninput = e=>{ t = +e.target.value; dirty=true; };
// dt_gamma/max_steps are STATIC compile keys in the render program —
// onchange (release), not oninput (every drag tick), or a single drag
// forces a recompile per tick and thrashes the 16-entry jit cache
document.getElementById('dtg').onchange = e=>ctl('dt_gamma', +e.target.value);
document.getElementById('mst').onchange = e=>ctl('max_steps', +e.target.value);
document.getElementById('spp').oninput = e=>ctl('max_spp', +e.target.value);
document.getElementById('aabb').onchange = e=>{
  const v = e.target.value.split(',').map(Number);
  ctl('aabb', (v.length==6 && v.every(isFinite)) ? v : null); };
document.getElementById('pause').onchange = e=>ctl('paused', e.target.checked);
function act(name){ fetch('/action', {method:'POST', body: JSON.stringify({name})})
  .then(r=>r.json()).then(s=>{ document.getElementById('msg').textContent = s.result; }); }
document.getElementById('ckptb').onclick = ()=>act('save_ckpt');
document.getElementById('meshb').onclick = ()=>act('save_mesh');
fetch('/status').then(r=>r.json()).then(s=>{ if(s.training) document.getElementById('trainctl').style.display='inline'; });
async function loop(){
  if(busy || !dirty){ requestAnimationFrame(loop); return; }
  busy=true; dirty=false;
  const t0=performance.now();
  const r = await fetch('/render', {method:'POST', body: JSON.stringify({theta,phi,radius,cx,cy,cz,t})});
  const blob = await r.blob();
  const img = await createImageBitmap(blob);
  ctx.imageSmoothingEnabled = false;
  ctx.drawImage(img, 0, 0, c.width, c.height);
  document.getElementById('fps').textContent = (1000/(performance.now()-t0)).toFixed(1);
  busy=false;
  requestAnimationFrame(loop);
}
setInterval(()=>{ fetch('/status').then(r=>r.json()).then(s=>{ if(s.training || s.spp < s.max_spp) dirty=true; }); }, 250);
loop();
</script></body></html>"""


class ViewerState:
    def __init__(
        self, render_fn, W=512, H=512, frame_budget_ms=200.0, train_fn=None,
        max_spp=16, actions=None,
    ):
        """render_fn(pose [4,4], intrinsics, H, W, time[, settings]) -> rgb
        [H, W, 3] float (numpy). A render_fn that accepts the 6th
        ``settings`` dict receives the live control-panel values (fovy/bg/
        dt_gamma/max_steps/aabb, ref gui.py:156-427); 5-arg render_fns keep
        working.

        train_fn: optional () -> loss, called in 16-step bursts on a worker
        thread (train-while-viewing, ref gui.py:89-111) until ``stop``.
        max_spp: accumulation cap for the still-camera progressive pass.
        actions: optional {name: () -> str} button callbacks (save_ckpt /
        save_mesh when a Trainer is attached).
        """
        self.render_fn = render_fn
        self.train_fn = train_fn
        self.W, self.H = W, H
        self.frame_budget_ms = frame_budget_ms
        self.downscale = 4  # start conservative, adapt
        self.training = train_fn is not None
        self.max_spp = max_spp
        self.actions = actions or {}
        self.paused = False
        self.settings = {
            "fovy": 50.0, "bg": 1.0, "dt_gamma": None, "max_steps": None,
            "aabb": None,
        }
        self._settings_version = 0
        try:
            n_params = len(inspect.signature(render_fn).parameters)
        except (TypeError, ValueError):
            n_params = 5
        self._pass_settings = n_params >= 6
        # progressive accumulation state (ref gui.py:142-148): while the
        # camera is still, frames rendered with sub-pixel jitter are averaged
        self.spp = 0
        self._accum: Optional[np.ndarray] = None
        self._last_key: Optional[tuple] = None
        # ThreadingHTTPServer serves each request on its own thread: one
        # render at a time reads and updates the accumulator
        self._render_lock = threading.Lock()
        self._stop = threading.Event()
        self._loss = float("nan")
        self._thread = None
        if self.training:
            self._thread = threading.Thread(target=self._train_loop, daemon=True)
            self._thread.start()

    def _train_loop(self):
        while not self._stop.is_set():
            if self.paused:  # ref gui.py start/stop train checkbox
                time.sleep(0.1)
                continue
            t0 = time.time()
            for _ in range(16):  # 16-step bursts (ref gui.py:89-111)
                self._loss = float(self.train_fn())
            # keep bursts near 500 ms by sleeping if too fast
            dt = time.time() - t0
            if dt < 0.1:
                time.sleep(0.1 - dt)

    def render(self, cam: dict) -> np.ndarray:
        with self._render_lock:
            return self._render(cam)

    def _render(self, cam: dict) -> np.ndarray:
        H = max(self.H // self.downscale, self.H // 4)
        W = max(self.W // self.downscale, self.W // 4)
        theta, phi, r = cam["theta"], cam["phi"], cam["radius"]
        center = np.array(
            [r * np.cos(phi) * np.sin(theta), r * np.sin(phi), r * np.cos(phi) * np.cos(theta)],
            np.float32,
        ) + np.array([cam.get("cx", 0), cam.get("cy", 0), cam.get("cz", 0)], np.float32)
        fwd = -center / (np.linalg.norm(center) + 1e-9)
        up = np.array([0, 1, 0], np.float32)
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right) + 1e-9
        down = np.cross(fwd, right)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = np.stack([right, down, fwd], -1)
        pose[:3, 3] = center
        focal = H / (2 * np.tan(np.radians(self.settings["fovy"]) / 2))

        # progressive SPP: identical camera+shape+settings -> keep averaging
        # jittered passes; any change resets the accumulator (gui.py:142-148)
        key = (round(theta, 6), round(phi, 6), round(r, 6),
               cam.get("cx", 0), cam.get("cy", 0), cam.get("cz", 0),
               round(cam.get("t", 0.0), 6), H, W, self.training,
               self._settings_version)
        if self.training and not self.paused:
            # params change every burst -> accumulated frames would be stale
            self._last_key = None
        if key != self._last_key or self._accum is None or self._accum.shape[0] != H:
            self._last_key = key
            self._accum = None
            self.spp = 0
        if self.spp >= self.max_spp:
            return np.clip(self._accum, 0, 1)
        # sub-pixel jitter on the principal point: pass 0 is centered so the
        # first frame is clean; later passes average fractional-pixel offsets
        if self.spp == 0:
            jx = jy = 0.0
        else:
            jx, jy = np.random.default_rng(self.spp).uniform(-0.5, 0.5, 2)

        t0 = time.time()
        args = (pose, (focal, focal, W / 2 + jx, H / 2 + jy), H, W, cam.get("t", 0.0))
        if self._pass_settings:
            args = args + (dict(self.settings),)
        rgb = np.asarray(self.render_fn(*args)).astype(np.float32)
        dt_ms = (time.time() - t0) * 1000
        self._accum = rgb if self._accum is None else (
            self._accum + (rgb - self._accum) / (self.spp + 1)
        )
        self.spp += 1
        # dynamic resolution targeting the budget (ref gui.py:134-140)
        if dt_ms > self.frame_budget_ms * 1.2 and self.downscale < 4:
            self.downscale += 1
        elif dt_ms < self.frame_budget_ms * 0.5 and self.downscale > 1:
            self.downscale -= 1
        return np.clip(self._accum, 0, 1)

    def stop(self, timeout: Optional[float] = None):
        """Stop the training thread (after its current burst) and join it;
        ``timeout`` bounds the wait. Returns whether the thread has ended."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            return not self._thread.is_alive()
        return True


def make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, body: bytes, content_type: str, code: int = 200):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code=200):
            self._send(json.dumps(obj).encode(), "application/json", code)

        def do_GET(self):
            if self.path == "/":
                self._send(_PAGE.encode(), "text/html")
            elif self.path == "/status":
                self._json({"training": state.training, "loss": state._loss,
                            "downscale": state.downscale, "spp": state.spp,
                            "max_spp": state.max_spp})
            else:
                self.send_response(404)
                self.end_headers()

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(n) or b"{}")
            if self.path == "/control":
                # merge known keys only; bump the version so the SPP
                # accumulator resets (stale frames under new settings)
                for k in list(state.settings) + ["max_spp", "paused"]:
                    if k in payload:
                        if k == "max_spp":
                            state.max_spp = max(1, int(payload[k]))
                        elif k == "paused":
                            state.paused = bool(payload[k])
                        else:
                            state.settings[k] = payload[k]
                state._settings_version += 1
                self._json({**state.settings, "max_spp": state.max_spp,
                            "paused": state.paused})
                return
            if self.path == "/action":
                name = payload.get("name", "")
                fn = state.actions.get(name)
                if fn is None:
                    self._json({"result": f"no action {name!r}"}, code=404)
                    return
                try:
                    out = fn()
                    self._json({"result": str(out) if out is not None else f"{name} done"})
                except Exception as e:  # surface, don't kill the server
                    self._json({"result": f"{name} failed: {e}"}, code=500)
                return
            if self.path != "/render":
                self.send_response(404)
                self.end_headers()
                return
            rgb = state.render(payload)
            self._send(encode_png((rgb * 255).astype(np.uint8)), "image/png")

    return Handler


def run_viewer(state: ViewerState, port: int = 7007):
    """Serve ``state`` on every interface until interrupted, on ``port`` (0:
    a free one); prints the URL with the port it bound."""
    server = ThreadingHTTPServer(("0.0.0.0", port), make_handler(state))
    print(f"[viewer] http://localhost:{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        state.stop()
