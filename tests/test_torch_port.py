"""Port package hygiene on the CPU: it imports no JAX (f), its kernel modules
import without nvcc (g), each kernel agrees with its plain version on a card
(skipped without one), and the PNG codec and option set match their twins."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import focnerf_tpu_torch
names = [m.name for m in pkgutil.walk_packages(focnerf_tpu_torch.__path__, "focnerf_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "focnerf_tpu")
             or m.startswith(("jax.", "jaxlib.", "focnerf_tpu.")))
print(len(names), "modules;", "foreign:", bad)
assert not bad, bad
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "foreign: []" in out.stdout


# the card's machine has none of these: every port module must import (and
# the viewer's frame encoder run) with each of them unimportable
_BLOCKED = ("PIL", "imageio", "cv2", "transformers", "ultralytics", "jax", "jaxlib")
_IMPORT_BLOCKED = r"""
import importlib, importlib.abc, sys
BLOCKED = %r
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is not installed on the card's machine")
sys.meta_path.insert(0, Block())
""" % (_BLOCKED,) + _IMPORT_ALL + r"""
import numpy as np
from focnerf_tpu_torch.data.png import decode_png, encode_png
frame = np.arange(4 * 6 * 3, dtype=np.uint8).reshape(4, 6, 3)
assert (decode_png(encode_png(frame)) == frame).all()
# one frame served through the viewer's handler, as on the card
import json, threading, urllib.request
from http.server import ThreadingHTTPServer
from focnerf_tpu_torch.viewer.server import ViewerState, make_handler
state = ViewerState(lambda pose, intr, H, W, t: np.full((H, W, 3), 0.5, np.float32), W=16, H=16)
srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
th = threading.Thread(target=srv.serve_forever)
th.start()
try:
    req = urllib.request.Request(f"http://127.0.0.1:{srv.server_address[1]}/render",
                                 data=json.dumps({"theta": 0.1, "phi": 0.1, "radius": 2.0}).encode())
    served = decode_png(urllib.request.urlopen(req, timeout=30).read())
finally:
    srv.shutdown()
    srv.server_close()
    th.join(10)
assert served.shape == (4, 4, 3) and (served == 127).all(), served
new = ("viewer.server", "apps.viewer_app", "train.lpips_npz", "data.native_loader", "train.clip_guidance",
       "data.yolo_sidecar", "train.loss", "ops.encoding", "utils.dilation", "utils.scripts", "utils.debug",
       "utils.profiling", "utils.flops")
print("imported:", all("focnerf_tpu_torch." + n in names for n in new))
def blocked(n):
    try:
        importlib.import_module(n)
    except ImportError:
        return True
    return False
print("blocked:", sorted(n for n in BLOCKED if blocked(n)))
"""


def test_port_imports_with_the_cards_packages_missing():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _IMPORT_BLOCKED], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "foreign: []" in out.stdout and "imported: True" in out.stdout
    assert f"blocked: {sorted(_BLOCKED)}" in out.stdout


def test_kernel_module_imports_without_nvcc(monkeypatch):
    from focnerf_tpu_torch.ops import _build, composite, hashgrid, marching

    assert composite.composite_rays_fused.launches >= 0
    assert composite.composite_rays_fused_backward.launches >= 0
    assert composite.composite_rays_resume.launches >= 0
    assert hashgrid.hashgrid_table_grad.launches >= 0
    assert hashgrid.hashgrid_encode_forward.launches >= 0
    assert hashgrid.hashgrid_input_grad.launches >= 0
    assert marching.march_rays_skip.launches >= 0
    assert _build.KERNEL_SOURCES == ("composite", "hashgrid_bwd", "hashgrid_fwd", "march_skip")
    for name in _build.KERNEL_SOURCES:
        path = _build.library_path(name)
        assert path.startswith(_build.BUILD_DIR) and path.endswith(".so")
        assert os.path.exists(os.path.join(_build.CSRC_DIR, f"{name}.cu"))
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    if not os.path.exists("/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.find_nvcc()


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from focnerf_tpu_torch.ops.composite import composite_rays, composite_rays_fused

    g = torch.Generator().manual_seed(0)
    n, t = 1000, 128
    sig = torch.rand(n, t, generator=g) * 50
    sig[7, 3] = float("inf")
    rgb = torch.rand(n, t, 3, generator=g)
    dts = torch.rand(n, t, generator=g) * 0.02 + 0.003
    ts = torch.cumsum(dts, -1)
    bg = torch.rand(n, 3, generator=g)
    dev = [x.cuda() for x in (sig, rgb, dts, ts, bg)]
    for thresh in (0.0, 1e-4):
        for bgc in (1.0, dev[4]):
            got = composite_rays_fused(*dev[:4], bg_color=bgc, T_thresh=thresh)
            torch.cuda.synchronize()
            ref = composite_rays(*dev[:4], bg_color=bgc, T_thresh=thresh)
            want = (ref["image"], ref["weights_sum"], ref["depth"])
            for a, b in zip(got, want):  # fp32 sums in another order
                torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_resume_kernel_matches_plain_on_card():
    """The forward kernel with a carried optical depth (the iterative
    renderer's rounds) against its plain version, at a ragged T."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from focnerf_tpu_torch.ops.composite import composite_rays_resume, composite_resume_plain

    g = torch.Generator().manual_seed(0)
    n, t = 1000, 20
    sig = torch.rand(n, t, generator=g) * 50
    sig[::3] *= 1e-3
    sig[7, 16] = float("inf")
    rgb = torch.rand(n, t, 3, generator=g)
    dts = torch.rand(n, t, generator=g) * 0.02 + 0.003
    ts = torch.cumsum(dts, -1)
    od0 = torch.rand(n, generator=g) * 8
    dev = [x.cuda() for x in (sig, rgb, dts, ts, od0)]
    for thresh in (0.0, 1e-4):
        before = composite_rays_resume.launches
        got = composite_rays_resume(*dev, T_thresh=thresh)
        torch.cuda.synchronize()
        assert composite_rays_resume.launches == before + 1
        want = composite_resume_plain(*dev, T_thresh=thresh)
        for a, b in zip(got[:3], want[:3]):  # fp32 sums in another order
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
        # a ray leaves the worklist in both or in neither; where it stays,
        # the outgoing optical depth agrees (the kernel stops a saturated
        # ray early, and its od is then the carry at the stop)
        stays = torch.exp(-want[3]) >= thresh
        assert torch.equal(stays, torch.exp(-got[3]) >= thresh)
        torch.testing.assert_close(got[3][stays], want[3][stays], rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_composite_backward_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from focnerf_tpu_torch.ops.composite import (
        composite_rays,
        composite_rays_fused,
        composite_rays_fused_backward,
    )

    g = torch.Generator().manual_seed(1)
    n, t = 1000, 128
    sig = torch.rand(n, t, generator=g) * 50
    sig[7, 3] = float("inf")
    rgb = torch.rand(n, t, 3, generator=g)
    dts = torch.rand(n, t, generator=g) * 0.02 + 0.003
    ts = torch.cumsum(dts, -1)
    bg = torch.rand(n, 3, generator=g)
    cot = [torch.randn(s, generator=g).cuda() for s in ((n, 3), (n,), (n,))]
    sig, rgb, dts, ts, bg = (x.cuda() for x in (sig, rgb, dts, ts, bg))
    for thresh in (0.0, 1e-4):
        grads = []
        for fn in ("kernel", "plain"):
            s, c = sig.clone().requires_grad_(), rgb.clone().requires_grad_()
            if fn == "kernel":
                before = composite_rays_fused_backward.launches
                out = composite_rays_fused(s, c, dts, ts, bg_color=bg, T_thresh=thresh)
            else:
                o = composite_rays(s, c, dts, ts, bg_color=bg, T_thresh=thresh)
                out = (o["image"], o["weights_sum"], o["depth"])
            sum((a * b).sum() for a, b in zip(out, cot)).backward()
            grads.append((s.grad, c.grad))
        torch.cuda.synchronize()
        assert composite_rays_fused_backward.launches == before + 1
        for a, b in zip(*grads):  # fp32 sums in another order
            assert torch.isfinite(a).all()
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_table_grad_kernel_matches_index_add_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from focnerf_tpu_torch.models.nerf import NeRFConfig
    from focnerf_tpu_torch.ops import hashgrid as thg

    spec = NeRFConfig(bound=2.0, stochastic_corners=1, stochastic_min_size=1).grid_spec
    g = torch.Generator().manual_seed(2)
    x = torch.rand(20000, 3, generator=g)
    u = torch.rand(20000, spec.num_levels, 1, 3, generator=g)
    table = torch.zeros(spec.table_rows, spec.level_dim)
    _, rows, weights = thg.hashgrid_encode_forward(table, x, spec, u, residuals=True)
    cot = torch.randn(20000, spec.output_dim, generator=g)
    cols = thg.col_levels(spec, True)
    want = thg.hashgrid_table_grad(rows, weights, cot, cols, spec.table_rows)
    before = thg.hashgrid_table_grad.launches
    got = thg.hashgrid_table_grad(rows.cuda(), weights.cuda(), cot.cuda(), cols, spec.table_rows)
    torch.cuda.synchronize()
    assert thg.hashgrid_table_grad.launches == before + 1
    # fp32 atomics add in no fixed order: compare to the largest row sum
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert torch.equal(got.cpu() == 0, want == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [3, 5])
def test_position_gradient_on_card_matches_cpu(dim):
    """The encode's position gradient (D-NeRF's deform and hyper fields) on
    the card against the CPU, with the table gradient through its kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the table-gradient kernel has no CPU mode")
    from focnerf_tpu_torch.ops import hashgrid as thg

    spec = thg.HashGridSpec.create(num_levels=16, level_dim=2, log2_hashmap_size=19, desired_resolution=4096,
                                   input_dim=dim)
    g = torch.Generator().manual_seed(dim)
    table = torch.rand(spec.table_rows, 2, generator=g) * 2 - 1
    x = torch.rand(20000, dim, generator=g) * 1.2 - 0.1
    cot = torch.randn(20000, spec.output_dim, generator=g)
    grads = {}
    for where in ("cuda", "cpu"):
        t = table.to(where).requires_grad_()
        xx = x.to(where).requires_grad_()
        before = thg.hashgrid_table_grad.launches
        (thg.hashgrid_encode(t, xx, spec) * cot.to(where)).sum().backward()
        grads[where] = (t.grad.cpu(), xx.grad.cpu(), thg.hashgrid_table_grad.launches - before)
    (tg, xg, launched), (tc, xc, _) = grads["cuda"], grads["cpu"]
    assert launched == 1
    oob = ((x < 0) | (x > 1)).any(-1)
    assert torch.all(xg[oob] == 0)
    # fp32 in another order: the finest level's scale (4095) times an ulp
    assert float((xg - xc).abs().max()) <= 1e-5 * float(xc.abs().max())
    assert float((tg - tc).abs().max()) <= 1e-5 * float(tc.abs().max())


def _encode_points(spec, n: int, seed: int):
    """n points in [0, 1]^D on the card, some outside the cube and some on
    cell faces or one ulp beside them (``chip_smoke.encode_points``)."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    g = torch.Generator(device="cuda").manual_seed(seed)
    return chip_smoke.encode_points(spec, torch.rand((n, spec.input_dim), generator=g, device="cuda"), g)


# (input_dim, K, stochastic_min_size, c2f active levels): exact D = 2, 3, 5;
# K 1 on every level (-O's); K 2 on the hashed levels; K 1 mixed with exact
# dense levels; a c2f stage's prefix of 8 levels
ENCODE_CASES = [(2, 0, 0, 0), (3, 0, 0, 0), (5, 0, 0, 0), (3, 1, 1, 0), (3, 2, 0, 0), (3, 1, 1 << 17, 0),
                (5, 1, 1, 0), (3, 1, 1, 8)]


def _full_width_spec(dim: int, k: int = 0, min_size: int = 0):
    from focnerf_tpu_torch.ops import hashgrid as thg

    spec = thg.HashGridSpec.create(num_levels=16, level_dim=2, log2_hashmap_size=19,
                                   desired_resolution=2048 if dim < 5 else 4096, input_dim=dim)
    return dataclasses.replace(spec, stochastic_k=k, stochastic_min_size=min_size)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,k,min_size,active", ENCODE_CASES)
def test_encode_kernel_matches_plain_on_card(dim, k, min_size, active):
    """The encode kernel against ``encode_plain`` on the card, full-width
    specs: rows bit for bit (faces included), weights and out to a few ulp
    (products and sums in another order), with and without residuals."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the encode kernel has no CPU mode")
    from focnerf_tpu_torch.ops import hashgrid as thg

    spec = _full_width_spec(dim, k, min_size)
    if active:
        spec = spec.truncate(active)
    n = 20000
    x = _encode_points(spec, n, dim + k)
    g = torch.Generator().manual_seed(dim)
    table = (torch.rand(spec.table_rows, 2, generator=g) * 2 - 1).cuda()
    stoch = thg.stochastic_levels(spec) if k else ()
    u = torch.rand(n, len(stoch), k, dim, generator=g).cuda() if k else None
    if min_size > 1:
        assert 0 < len(stoch) < spec.num_levels
    before = thg.hashgrid_encode_forward.launches
    out, rows, weights = thg.hashgrid_encode_forward(table, x, spec, u, residuals=True)
    bare, none_rows, none_weights = thg.hashgrid_encode_forward(table, x, spec, u, residuals=False)
    torch.cuda.synchronize()
    assert thg.hashgrid_encode_forward.launches == before + 2 and none_rows is None and none_weights is None
    pout, prows, pweights = thg.encode_plain(table, x, spec, u, residuals=True)
    assert torch.equal(rows, prows)
    assert torch.equal(out, bare)
    oob = ((x < 0) | (x > 1)).any(-1)
    assert torch.all(weights[oob] == 0) and torch.all(out[oob] == 0)
    torch.testing.assert_close(weights, pweights, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(out, pout, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_encode_kernel_feeds_the_grad_levels_backward_on_card():
    """An -O2 phase (``grad_levels``) in a c2f stage: the kernel's residuals,
    columns selected, through the table-gradient kernel, against the CPU's
    plain path; the other levels' rows exactly 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the encode kernel has no CPU mode")
    from focnerf_tpu_torch.ops import hashgrid as thg

    spec = dataclasses.replace(_full_width_spec(3, 1, 1), grad_levels=(1, 3, 5, 7))
    n, active = 20000, 8
    x = _encode_points(spec.truncate(active), n, 7).cpu()
    g = torch.Generator().manual_seed(7)
    table = torch.rand(spec.table_rows, 2, generator=g) * 2 - 1
    u = torch.rand(n, len(thg.stochastic_levels(spec.truncate(active))), 1, 3, generator=g)
    cot = torch.randn(n, spec.output_dim, generator=g)
    grads = {}
    for where in ("cuda", "cpu"):
        t = table.to(where).requires_grad_()
        before = thg.hashgrid_encode_forward.launches
        (thg.hashgrid_encode_c2f(t, x.to(where), spec, active, u.to(where)) * cot.to(where)).sum().backward()
        grads[where] = (t.grad.cpu(), thg.hashgrid_encode_forward.launches - before)
    (got, launched), (want, _) = grads["cuda"], grads["cpu"]
    assert launched == 1
    assert torch.equal(got == 0, want == 0)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    for lvl in range(spec.num_levels):
        live = lvl in spec.grad_levels and lvl < active
        assert live == bool((got[spec.offsets[lvl]:spec.offsets[lvl + 1]] != 0).any()), lvl


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [3, 5])
def test_position_gradient_kernel_matches_plain_on_card(dim):
    """The position-gradient kernel against ``input_grad_plain`` on the card:
    1e-5 rel L2; exactly 0 outside the cube; two runs equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the position-gradient kernel has no CPU mode")
    from focnerf_tpu_torch.ops import hashgrid as thg

    spec = _full_width_spec(dim)
    n = 20000
    x = _encode_points(spec, n, dim)
    g = torch.Generator().manual_seed(dim)
    table = (torch.rand(spec.table_rows, 2, generator=g) * 2 - 1).cuda()
    cot = torch.randn(n, spec.output_dim, generator=g).cuda()
    before = thg.hashgrid_input_grad.launches
    got = thg.hashgrid_input_grad(table, x, cot, spec)
    again = thg.hashgrid_input_grad(table, x, cot, spec)
    torch.cuda.synchronize()
    assert thg.hashgrid_input_grad.launches == before + 2
    want = thg.input_grad_plain(table, x, cot, spec)
    assert torch.equal(got, again)
    oob = ((x < 0) | (x > 1)).any(-1)
    assert torch.all(got[oob] == 0)
    assert float((got - want).norm() / want.norm()) <= 1e-5


@pytest.mark.cuda
def test_encode_kernel_replays_in_a_cuda_graph():
    """The encode (with residuals, K 1 draws) and the position gradient
    captured into a CUDA graph (as the fused dispatch captures a step)
    replay to the plain versions on new points and draws."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the encode kernels have no CPU mode")
    from focnerf_tpu_torch.ops import hashgrid as thg

    spec = _full_width_spec(3, 1, 1)
    exact = _full_width_spec(3)
    n = 8192
    g = torch.Generator().manual_seed(11)
    table = (torch.rand(spec.table_rows, 2, generator=g) * 2 - 1).cuda()
    x = _encode_points(spec, n, 11)
    u = torch.rand(n, spec.num_levels, 1, 3, generator=g).cuda()
    cot = torch.randn(n, spec.output_dim, generator=g).cuda()
    thg.hashgrid_encode_forward(table, x, spec, u, residuals=True)  # built and warm before the capture
    thg.hashgrid_input_grad(table, x, cot, exact)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = thg.hashgrid_encode_forward(table, x, spec, u, residuals=True)
        got_gx = thg.hashgrid_input_grad(table, x, cot, exact)
    x.copy_(_encode_points(spec, n, 12))
    u.copy_(torch.rand(n, spec.num_levels, 1, 3, generator=g).cuda())
    graph.replay()
    want = thg.encode_plain(table, x, spec, u, residuals=True)
    want_gx = thg.input_grad_plain(table, x, cot, exact)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
    assert float((got_gx - want_gx).norm() / want_gx.norm()) <= 1e-5


def _tile_spec(dim: int, level_dim: int = 2, levels: int = 16, k: int = 0):
    """Dense and hashed levels for any D: resolution 2 growing 1.5x a level
    (1.2x over 32 levels), at most 2^min(4 + 2D, 14) rows a level; K drawn
    corners on every level (0: exact)."""
    from focnerf_tpu_torch.ops import hashgrid as thg

    spec = thg.HashGridSpec.create(num_levels=levels, level_dim=level_dim, base_resolution=2,
                                   log2_hashmap_size=min(4 + 2 * dim, 14),
                                   per_level_scale=1.5 if levels <= 16 else 1.2, input_dim=dim)
    return dataclasses.replace(spec, stochastic_k=k, stochastic_min_size=1 if k else 0)


# the tiles' edges: (input_dim, level_dim, levels, K, points, x unaligned);
# points "P-1", "P+1" and "5P+37" count in each kernel's own tile of P points
TILE_CASES = {
    "points 1": (3, 2, 16, 1, 1, False),
    "points 31": (3, 2, 16, 1, 31, False),
    "points 33": (3, 2, 16, 1, 33, False),
    "points P-1": (3, 2, 16, 1, "P-1", False),
    "points P+1": (3, 2, 16, 1, "P+1", False),
    "points 5P+37": (3, 2, 16, 1, "5P+37", False),
    "level_dim 1": (3, 1, 16, 1, 5000, False),
    "level_dim 4": (3, 4, 16, 1, 5000, False),
    "level_dim 8": (3, 8, 16, 1, 5000, False),
    "levels 1": (3, 2, 1, 1, 5000, False),
    "levels 32": (3, 2, 32, 1, 5000, False),
    "K 2": (3, 2, 16, 2, 5000, False),
    "K 4": (3, 2, 16, 4, 5000, False),
    "D 1": (1, 2, 16, 1, 5000, False),
    "D 5": (5, 2, 16, 1, 5000, False),
    "D 7": (7, 2, 16, 1, 5000, False),
    "x unaligned": (3, 2, 16, 1, 5000, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TILE_CASES))
def test_encode_kernels_on_tile_edges_on_card(case):
    """Both encode kernels where their tiles end: tails of every length, a
    point's row of 1, 4 or 8 channels (no float2), 1 and 32 levels, K 2 and
    4, D 1, 5 and 7 (the exact encodes' residuals staged a chunk of levels at
    a time), x starting off a 16-byte boundary. The encode (drawn corners,
    and exact) against ``encode_plain``: rows bit for bit, weights 1e-6
    relative + 1e-7, out 1e-6 (a U(-1, 1) table), the same out with and
    without residuals, two runs equal; the position gradient against
    ``input_grad_plain``: 1e-5 rel L2, two runs equal; 0 outside the cube."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the encode kernels have no CPU mode")
    from focnerf_tpu_torch.ops import hashgrid as thg

    dim, C, L, k, count, unaligned = TILE_CASES[case]
    spec = _tile_spec(dim, C, L, k)
    exact = dataclasses.replace(spec, stochastic_k=0, stochastic_min_size=0)
    assert any(spec.hashed) or L == 1
    g = torch.Generator().manual_seed(dim * 100 + C * 10 + k)
    table = (torch.rand(spec.table_rows, C, generator=g) * 2 - 1).cuda()

    def points(P, seed):
        n = count if isinstance(count, int) else {"P-1": P - 1, "P+1": P + 1, "5P+37": 5 * P + 37}[count]
        x = _encode_points(spec, n + unaligned, seed)[unaligned:]
        assert (x.data_ptr() % 16 != 0) == unaligned
        return x

    for sp, draws in ((spec, True), (exact, False)):
        x = points(thg.spec_encode_tile(sp, draws, True, thg.kernel_regs("encode", dim)).points, dim + k)
        n = x.shape[0]
        u = torch.rand(n, len(thg.stochastic_levels(sp)), k, dim, generator=g).cuda() if draws else None
        out, rows, weights = thg.hashgrid_encode_forward(table, x, sp, u, residuals=True)
        again = thg.hashgrid_encode_forward(table, x, sp, u, residuals=True)
        bare, _, _ = thg.hashgrid_encode_forward(table, x, sp, u, residuals=False)
        pout, prows, pweights = thg.encode_plain(table, x, sp, u, residuals=True)
        torch.cuda.synchronize()
        assert torch.equal(rows, prows), case
        assert all(torch.equal(a, b) for a, b in zip((out, rows, weights), again)) and torch.equal(out, bare)
        oob = ((x < 0) | (x > 1)).any(-1)
        assert torch.all(weights[oob] == 0) and torch.all(out[oob] == 0)
        torch.testing.assert_close(weights, pweights, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(out, pout, rtol=0, atol=1e-6)
    x = points(thg.input_grad_tile(L, dim, C, thg.kernel_regs("input_grad", dim)).points, dim + k + 1)
    cot = torch.randn(x.shape[0], spec.output_dim, generator=g).cuda()
    got = thg.hashgrid_input_grad(table, x, cot, exact)
    again = thg.hashgrid_input_grad(table, x, cot, exact)
    want = thg.input_grad_plain(table, x, cot, exact)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.all(got[((x < 0) | (x > 1)).any(-1)] == 0)
    assert float((got - want).norm()) <= 1e-5 * float(want.norm())


def _skip_field_and_rays(n: int, seed: int, device):
    """A two-cascade skip field of shells and a slab (H = 64) and n rays from
    cameras at radius 3 through the box."""
    from focnerf_tpu_torch.core.geometry import near_far_from_aabb
    from focnerf_tpu_torch.ops.occupancy import occupancy_skip_field

    G, bound = 64, 2.0
    ax = (torch.arange(G).float() + 0.5) / G * 2 - 1
    X, Y, Z = torch.meshgrid(ax, ax, ax, indexing="ij")
    bits = []
    for c in range(2):
        r = torch.sqrt(X * X + Y * Y + Z * Z) * 2.0**c
        bits.append((((r > 0.7) & (r < 0.85)) | ((X * 2.0**c - 0.3).abs() < 0.05)).reshape(-1))
    skip = occupancy_skip_field(torch.stack(bits), grid_size=G).to(device)
    g = torch.Generator().manual_seed(seed)
    eye = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=-1) * 3.0
    d = torch.nn.functional.normalize(torch.randn(n, 3, generator=g) * 0.5 - eye, dim=-1)
    o, d = eye.to(device), d.to(device)
    near, far = near_far_from_aabb(o, d, torch.tensor([-bound] * 3 + [bound] * 3, device=device), 0.2)
    noise = torch.rand(n, generator=g).to(device)
    return o, d, near, far, skip, noise, dict(bound=bound, grid_size=G, max_steps=1024)


# (slab, dt_gamma, jitter, max_iters, field, start, rays): the -O and
# iterative shapes; no dt growth; an iteration cap; on a field occupied
# everywhere a run that reaches the slab (40), passes far or meets the cap in
# the middle of a lane group; rays that start past far; slabs that are not a
# multiple of the group (24 of 2 lanes, 100 of 8) and the smallest (8); the
# iterative round's restart from where its first round stopped, under its
# cap, at the iterative round's width (one lane a ray from 32768 rays)
MARCH_CASES = [
    (128, 1 / 128, True, 0, "shells", "near", 4096),
    (16, 1 / 128, False, 0, "shells", "near", 4096),
    (64, 0.0, True, 0, "shells", "near", 4096),
    (32, 1 / 128, True, 20, "shells", "near", 4096),
    (40, 1 / 128, True, 0, "occupied", "near", 4096),
    (128, 1 / 128, False, 0, "occupied", "short", 4096),
    (128, 1 / 128, True, 20, "occupied", "near", 4096),
    (32, 1 / 128, True, 0, "shells", "past_far", 4096),
    (24, 1 / 128, True, 0, "shells", "near", 4096),
    (100, 1 / 128, True, 0, "shells", "near", 4096),
    (8, 1 / 128, True, 0, "shells", "near", 4096),
    (16, 1 / 128, False, 24, "shells", "restart", 32768),
]


@pytest.mark.cuda
@pytest.mark.parametrize("slab,dt_gamma,jitter,max_iters,field,start,rays", MARCH_CASES)
def test_march_kernel_matches_plain_walk(slab, dt_gamma, jitter, max_iters, field, start, rays):
    """The skip-walk kernel equals the plain walk on the card bit for bit
    (ts, dts, valid, count), one launch a walk, at the -O and iterative
    shapes, without dt growth, under an iteration cap, and where a walk ends
    in the middle of a lane group (MARCH_CASES)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the march kernel has no CPU mode")
    from focnerf_tpu_torch.ops import marching

    o, d, near, far, skip, noise, kw = _skip_field_and_rays(rays, slab, "cuda")
    if field == "occupied":
        skip = torch.zeros_like(skip)
    if start == "short":  # far within a few dozen steps of the near
        far = torch.minimum(far, near + 0.3 * torch.rand(near.shape, device="cuda",
                                                         generator=torch.Generator(device="cuda").manual_seed(3)))
    past = torch.arange(near.shape[0], device="cuda") % 3 == 0
    if start == "past_far":
        near = torch.where(past, far + 0.1, near)
    if start == "restart":
        first = marching.march_rays_skip(o, d, near, far, skip, dt_gamma=dt_gamma, slab=slab, **kw)
        last = torch.clamp(first.count - 1, min=0)[:, None]
        near = torch.where(first.count > 0, (first.ts.gather(1, last) + first.dts.gather(1, last))[:, 0], far)
    kw.update(dt_gamma=dt_gamma, slab=slab, max_iters=max_iters, noise=noise if jitter else None)
    before = marching.march_rays_skip.launches
    got = marching.march_rays_skip(o, d, near, far, skip, **kw)
    want = marching.march_skip_plain(o, d, near, far, skip, **kw)
    torch.cuda.synchronize()
    assert marching.march_rays_skip.launches == before + 1
    for name in ("ts", "dts", "valid", "count"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert bool((got.ray_iters >= got.count).all())
    assert int(got.iters) == int(got.ray_iters.max()) > 0
    assert 0 <= want.iters - int(got.iters) < 4  # the plain walk counts in steps of 4
    if start == "past_far":
        assert int(got.count[past].max()) == 0 and int(got.ray_iters[past].max()) == 0
    if field == "occupied" and start == "near":  # the longest walk ends on its slab or its cap
        assert int(got.count.max()) == (min(slab, max_iters) if max_iters else slab)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,ramp", [(1, 1), (2, 1), (2, 2), (4, 1), (4, 4), (8, 2), (16, 4), (32, 1), (32, 32)])
def test_march_kernel_lane_groups_match_plain_walk(monkeypatch, lanes, ramp):
    """Every lane group the kernel is built for, at every ramp, equals the
    plain walk bit for bit (the wrapper's policy picks only some of them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the march kernel has no CPU mode")
    from focnerf_tpu_torch.ops import marching

    o, d, near, far, skip, noise, kw = _skip_field_and_rays(4096, 7, "cuda")
    kw.update(dt_gamma=1 / 128, slab=72, noise=noise)
    monkeypatch.setattr(marching, "march_lanes", lambda n, slab: (lanes, ramp))
    got = marching.march_rays_skip(o, d, near, far, skip, **kw)
    want = marching.march_skip_plain(o, d, near, far, skip, **kw)
    torch.cuda.synchronize()
    for name in ("ts", "dts", "valid", "count"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert int(got.iters) == int(got.ray_iters.max())


@pytest.mark.cuda
def test_march_kernel_replays_in_a_cuda_graph():
    """The skip walk captured into a CUDA graph (as the fused dispatch
    captures a step) replays to the plain walk's samples on new starts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the march kernel has no CPU mode")
    from focnerf_tpu_torch.ops import marching

    o, d, near, far, skip, noise, kw = _skip_field_and_rays(4096, 9, "cuda")
    kw.update(dt_gamma=1 / 128, slab=128)
    start = near.clone()
    marching.march_rays_skip(o, d, start, far, skip, **kw)  # built and warm before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = marching.march_rays_skip(o, d, start, far, skip, **kw)
    start.copy_(near + 0.05 * noise)
    graph.replay()
    want = marching.march_skip_plain(o, d, start, far, skip, **kw)
    torch.cuda.synchronize()
    for name in ("ts", "dts", "valid", "count"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_codec_roundtrips_and_reads_imageio_files(tmp_path, channels):
    imageio = pytest.importorskip("imageio.v2")
    from focnerf_tpu_torch.data.png import read_png, write_png

    rng = np.random.default_rng(channels)
    # smooth gradients plus noise, so an encoder picks a mix of filter types
    yy, xx = np.mgrid[0:37, 0:53]
    base = (xx * 3 + yy * 5)[..., None] + rng.integers(0, 40, (37, 53, channels))
    img = (base % 256).astype(np.uint8)
    if channels == 1:
        img = img[..., 0]
    ours = str(tmp_path / "ours.png")
    write_png(ours, img)
    np.testing.assert_array_equal(np.asarray(imageio.imread(ours)), img)
    theirs = str(tmp_path / "theirs.png")
    imageio.imwrite(theirs, img)
    got = read_png(theirs)
    np.testing.assert_array_equal(got[..., 0] if channels == 1 else got, img)


def test_png_unfilter_all_filter_types():
    from focnerf_tpu_torch.data.png import _paeth, _unfilter

    rng = np.random.default_rng(0)
    H, W, C = 6, 9, 3
    img = rng.integers(0, 256, (H, W, C)).astype(np.int32)
    rows, prev = [], np.zeros(W * C, np.int32)
    for y in range(H):  # encode row y with filter type y % 5
        cur = img[y].reshape(-1)
        left = np.concatenate([np.zeros(C, np.int32), cur[:-C]])
        up_left = np.concatenate([np.zeros(C, np.int32), prev[:-C]])
        ftype = y % 5
        pred = [0, left, prev, (left + prev) // 2, _paeth(left, prev, up_left)][ftype]
        rows.append(np.concatenate([[ftype], (cur - pred) & 0xFF]))
        prev = cur
    data = np.concatenate(rows).astype(np.uint8)
    np.testing.assert_array_equal(_unfilter(data, H, W, C), img.astype(np.uint8))


@pytest.mark.parametrize(
    "argv", [[], ["-O"], ["-O2"], ["-O", "--grid_levels", "8", "--bound", "1.5"]]
)
def test_options_twin_matches_jax(argv):
    from focnerf_tpu.config import Options as JOptions
    from focnerf_tpu.config import parse_options as jparse
    from focnerf_tpu_torch.config import Options, parse_options

    assert [f.name for f in dataclasses.fields(Options)] == [
        f.name for f in dataclasses.fields(JOptions)
    ]
    j, t = jparse(["scene"] + argv), parse_options(["scene"] + argv)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    # the model config the CLI builds, in model_config.json form, is the same
    from focnerf_tpu_torch.interop import config_to_dict

    jc, tc = j.nerf_config(), t.nerf_config()
    jd = dataclasses.asdict(jc)
    jd["compute_dtype"] = "bfloat16" if "bfloat16" in str(jc.compute_dtype) else "float32"
    td = config_to_dict(tc)
    td.pop("__class__")
    assert td == jd
