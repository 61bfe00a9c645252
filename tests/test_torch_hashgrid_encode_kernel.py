"""The hash encode's forward and position gradient around their CUDA
kernels (csrc/hashgrid_fwd.cu), on the CPU: the dispatchers take the plain
versions for CPU tensors and raise on other devices; the level table the
kernels receive by value equals the JAX package's spec; the plain encode
(``encode_plain``) equals JAX's ``_encode_impl`` for D = 2, 3 and 5, exact,
stochastic and mixed specs, K = 1 and 2, with points on cell faces and
outside the unit cube; the plain position gradient (``input_grad_plain``)
equals ``jax.grad`` for D = 2; the wrappers refuse what the kernels do not
take before they build anything, and import without nvcc.

Inputs and draws come from numpy with a seed and go through both packages;
each assertion states its tolerance and why. The kernels themselves run
only on a card: tests/test_torch_port.py (marked ``cuda``) and
chip_smoke.py's ``[kernel-encode]``.
"""

import ctypes
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focnerf_tpu.ops import hashgrid as jhg
from focnerf_tpu_torch.ops import hashgrid as thg
from test_torch_model import start_torch_threads

start_torch_threads()

N = 400
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _specs(dim: int, k: int = 0, min_size: int = 0):
    """4 levels in a 2^11 table, some dense and some hashed: D = 2 and 3
    from resolution 4 to 64, D = 5 from 2 to 32 (at 4, every D = 5 level
    would hash)."""
    base, top = (2, 32) if dim == 5 else (4, 64)
    kw = dict(num_levels=4, level_dim=2, base_resolution=base, log2_hashmap_size=11, desired_resolution=top,
              input_dim=dim)
    js, ts = jhg.HashGridSpec.create(**kw), thg.HashGridSpec.create(**kw)
    assert any(ts.hashed) and not all(ts.hashed)
    return (dataclasses.replace(js, stochastic_k=k, stochastic_min_size=min_size),
            dataclasses.replace(ts, stochastic_k=k, stochastic_min_size=min_size))


def _points(spec, seed: int):
    """N points in [0, 1]^D; then some outside it, the cube's faces, and on
    every level points whose pos = x * scale + 0.5 lands on (or one ulp
    beside) a cell face."""
    rng = np.random.default_rng(seed)
    D = spec.input_dim
    x = rng.uniform(0, 1, (N, D)).astype(np.float32)
    x[:30] = rng.uniform(-0.5, 1.5, (30, D))
    x[30:34] = [[0.0] * D, [1.0] * D, [0.0, 1.0] * (D // 2) + [0.5] * (D % 2), [1.0, 0.0] * (D // 2) + [1.0] * (D % 2)]
    i = 34
    for lvl in range(spec.num_levels):
        scale = np.float32(thg._level_scale(spec, lvl))
        for face in rng.integers(1, max(int(scale), 2), 12):
            f = np.float32((face - 0.5) / scale)
            x[i] = rng.uniform(0, 1, D)
            x[i, rng.integers(0, D)] = [f, np.nextafter(f, np.float32(2)), np.nextafter(f, np.float32(-1))][i % 3]
            i += 1
    return x


def _draws(jspec, n: int, seed: int):
    n_stoch = sum(jhg._is_stochastic_level(jspec, lvl) for lvl in range(jspec.num_levels))
    return np.random.default_rng(seed).uniform(0, 1, (n, n_stoch, jspec.stochastic_k, jspec.input_dim)).astype(
        np.float32)


# (K, stochastic_min_size): exact; K 1 on every level (-O's); K 2 on the
# hashed levels alone; K 1 on the hashed levels and the dense levels of at
# least 512 rows, exact below (mixed)
MODES = {"exact": (0, 0), "k1_all": (1, 1), "k2_hashed": (2, 0), "k1_mixed": (1, 512)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("dim", [2, 3, 5])
def test_plain_encode_matches_jax_encode_impl(dim, mode):
    k, min_size = MODES[mode]
    js, ts = _specs(dim, k, min_size)
    stoch = thg.stochastic_levels(ts) if k else ()
    if mode == "k1_mixed":  # exact and drawn levels in one spec (D = 2, 3: a dense one among the drawn)
        assert 0 < len(stoch) < ts.num_levels and (dim == 5 or any(not ts.hashed[lvl] for lvl in stoch))
    x = _points(ts, seed=dim * 10 + k)
    table = np.random.default_rng(dim).uniform(-1, 1, (ts.table_rows, 2)).astype(np.float32)
    u = _draws(js, N, seed=dim + 100 * k) if k else None
    ju = jnp.asarray(u) if k else jnp.zeros((N, 0, 0, 0), jnp.float32)
    jout, jrows, jw = jhg._encode_impl(jnp.asarray(table), jnp.asarray(x), js, ju)
    tout, trows, tw = thg.encode_plain(torch.from_numpy(table), torch.from_numpy(x), ts,
                                       None if u is None else torch.from_numpy(u), residuals=True)
    assert thg.col_levels(ts, k > 0) == tuple(lvl for lvl, (_, n) in enumerate(jhg._col_layout(js)) for _ in range(n))
    oob = ((x < 0) | (x > 1)).any(-1)
    assert 0 < oob.sum() < N
    # rows: integer arithmetic, identical inside the cube, faces included (the
    # port moves outside points to the origin, JAX keeps their wrapped
    # coordinates; both give them weight 0)
    np.testing.assert_array_equal(trows.numpy()[~oob], np.asarray(jrows)[~oob])
    assert np.all(tw.numpy()[oob] == 0) and np.all(np.asarray(jw)[oob] == 0)
    # weights: the same fp32 products (1 ulp), 1/K on drawn corners
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)
    # out: the same products; JAX sums the corners through a selection matmul
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
    assert np.all(tout.numpy()[oob] == 0)


def test_plain_position_gradient_matches_jax_2d():
    """D = 2 (the background grid's): ``input_grad_plain`` against jax.grad
    of JAX's input_grads=True encode (D = 3 and 5:
    tests/test_torch_hashgrid_input_grads.py)."""
    js, ts = _specs(2)
    x = _points(ts, seed=4)
    rng = np.random.default_rng(5)
    table = rng.uniform(-1, 1, (ts.table_rows, 2)).astype(np.float32)
    cot = rng.normal(size=(N, ts.output_dim)).astype(np.float32)
    jgx = jax.grad(lambda xx: jnp.sum(jhg.hashgrid_encode(jnp.asarray(table), xx, js, input_grads=True) * cot))(
        jnp.asarray(x))
    tgx = thg.input_grad_plain(torch.from_numpy(table), torch.from_numpy(x), torch.from_numpy(cot), ts).numpy()
    oob = ((x < 0) | (x > 1)).any(-1)
    assert np.all(tgx[oob] == 0) and np.all(np.asarray(jgx)[oob] == 0)
    # fp32 sums in another order, times the finest level's scale (63)
    np.testing.assert_allclose(tgx, np.asarray(jgx), rtol=0, atol=2e-6 * np.abs(np.asarray(jgx)).max())


@pytest.mark.parametrize("dim,k,min_size,active", [(2, 0, 0, 0), (3, 0, 0, 0), (5, 0, 0, 0), (3, 1, 1, 0),
                                                   (3, 2, 0, 0), (5, 1, 512, 0), (3, 1, 1, 3)])
def test_level_table_matches_jax_spec(dim, k, min_size, active):
    """The struct the kernels take by value: JAX's per-level scale (the fp32
    of _level_corner_indices), offsets, sizes, resolutions and hashed flags,
    and the residual columns of JAX's _col_layout (a c2f stage's truncated
    spec too)."""
    js, ts = _specs(dim, k, min_size)
    if active:
        js, ts = js.truncate(active), ts.truncate(active)
    lt = thg.level_table(ts, k > 0)
    layout = jhg._col_layout(js)
    assert (lt.num_levels, lt.input_dim, lt.level_dim, lt.k) == (js.num_levels, dim, js.level_dim, k)
    assert lt.total_cols == sum(n for _, n in layout)
    assert lt.inv_k == (np.float32(1.0 / k) if k else 0.0)
    n_stoch = 0
    for lvl in range(js.num_levels):
        want = np.float32(np.exp2(lvl * np.log2(js.per_level_scale)) * js.base_resolution - 1.0)
        assert np.float32(lt.scale[lvl]) == want
        assert (lt.offset[lvl], lt.mask[lvl], lt.res1[lvl], bool(lt.hashed[lvl])) == (
            js.offsets[lvl], js.level_size(lvl) - 1 if js.hashed[lvl] else 0, js.resolutions[lvl] + 1, js.hashed[lvl])
        start, ncols = layout[lvl]
        assert lt.col[lvl] == start
        drawn = k > 0 and jhg._is_stochastic_level(js, lvl)
        assert lt.stoch[lvl] == (n_stoch if drawn else -1)
        n_stoch += drawn
    assert lt.n_stoch == n_stoch
    assert all(lt.stoch[lvl] == -1 for lvl in range(js.num_levels)) or k > 0
    if k:  # the exact table of the same spec: no level drawn, 2^D columns each
        exact = thg.level_table(ts, False)
        assert exact.total_cols == js.num_levels << dim and all(exact.stoch[lvl] == -1 for lvl in range(js.num_levels))


def _struct_members(name: str):
    with open(os.path.join(ROOT, "focnerf_tpu_torch", "csrc", "hashgrid_fwd.cu")) as f:
        body = re.search(r"struct %s \{(.*?)\};" % name, f.read(), re.S).group(1)
    return re.findall(r"^\s*(?:int|float|uint32_t)\s+(\w+)(?:\[kMaxLevels\])?;", body, re.M)


def test_level_table_struct_matches_the_kernel_source():
    """``_LevelTable``'s fields are csrc/hashgrid_fwd.cu's ``LevelTable``
    members, in order, all 4-byte (no padding on either side)."""
    assert _struct_members("LevelTable") == [name for name, _ in thg._LevelTable._fields_]
    assert ctypes.sizeof(thg._LevelTable) == 7 * 4 + 7 * 4 * thg._MAX_LEVELS


def test_tile_struct_matches_the_kernel_source():
    """``_Tile``'s fields are csrc/hashgrid_fwd.cu's ``Tile`` members, in
    order, all int; the kernel's warp and shared-memory limits are the
    host's."""
    assert _struct_members("Tile") == [name for name, _ in thg._Tile._fields_]
    assert ctypes.sizeof(thg._Tile) == 4 * len(thg._Tile._fields_)
    with open(os.path.join(ROOT, "focnerf_tpu_torch", "csrc", "hashgrid_fwd.cu")) as f:
        src = f.read()
    assert f"constexpr int kMaxWarps = {max(thg.TILE_WARPS)};" in src
    assert f"constexpr int kMaxSmemBytes = {thg.SMEM_LIMIT};" in src


def _cli_specs():
    """Every hash-grid spec the CLIs build, by name."""
    from focnerf_tpu_torch.config import parse_options

    cfg = parse_options(["scene", "-O"]).nerf_config()
    o2 = parse_options(["scene", "-O2"]).nerf_config().grid_spec
    return {
        "-O": cfg.grid_spec,
        "-O2 stage": dataclasses.replace(o2, grad_levels=(1, 3, 5, 7)).truncate(8),
        "background": cfg.bg_grid_spec,
        "deform": parse_options(["scene", "-O"]).dnerf_config().field_spec,
        "hyper": parse_options(["scene", "-O", "--hyper"]).dnerf_config().field_spec,
        "exact": dataclasses.replace(cfg.grid_spec, stochastic_k=0, stochastic_min_size=0),
    }


@pytest.mark.parametrize("name", ["-O", "-O2 stage", "background", "deform", "hyper", "exact"])
def test_level_table_masks_the_hash_of_every_cli_spec(name):
    """The kernels mask a hashed level's hash where the plain version takes
    it modulo the size: every hashed level of every spec the CLIs build has
    a power-of-two size and mask size - 1 (so ``h & mask == h % size`` for
    every uint32 h), every dense level mask 0."""
    spec = _cli_specs()[name]
    assert any(spec.hashed)
    for stochastic in (False, True):
        lt = thg.level_table(spec, stochastic)
        for lvl in range(spec.num_levels):
            size = spec.level_size(lvl)
            if spec.hashed[lvl]:
                assert size & (size - 1) == 0 and lt.mask[lvl] == size - 1
                h = np.random.default_rng(lvl).integers(0, 2**32, 1000, dtype=np.uint64)
                np.testing.assert_array_equal(h & np.uint64(lt.mask[lvl]), h % np.uint64(size))
            else:
                assert lt.mask[lvl] == 0


def test_level_table_refuses_a_hashed_level_not_a_power_of_two():
    """A hand-made spec whose hashed level's size is no power of two: the
    plain version still takes it (modulo), the kernels' wrappers refuse it
    before they build anything."""
    _, ts = _specs(3)
    lvl = ts.hashed.index(True)
    offsets = list(ts.offsets)
    offsets[lvl + 1:] = [o - 8 for o in offsets[lvl + 1:]]  # the level loses 8 of its 2^11 rows
    bad = dataclasses.replace(ts, offsets=tuple(offsets))
    assert bad.level_size(lvl) == 2**11 - 8
    with pytest.raises(ValueError, match="not a power of two"):
        thg.level_table(bad, False)
    table = torch.zeros((bad.table_rows, 2))
    x = torch.rand(64, 3, generator=torch.Generator().manual_seed(3))
    with pytest.raises(ValueError, match="not a power of two"):
        thg._encode_launch(table, x, bad, None, residuals=True)
    with pytest.raises(ValueError, match="not a power of two"):
        thg._input_grad_launch(table, x, torch.zeros((64, bad.output_dim)), bad)
    out, _, _ = thg.encode_plain(table, x, bad, None, residuals=False)
    assert out.shape == (64, bad.output_dim)


def _check_tile(t, L, D, C, ulen, res_cols, grad, regs):
    """A tile the kernels can take: P a multiple of 32 (at most 128), each
    chunk's (32-point group, level) items shared evenly by at most the
    kernel's warps, within the block's shared memory, each tile at a
    16-byte offset after the one before, each stride odd and at least its
    row; where any tile would, its resident blocks leave L1 its share."""
    assert t.points % 32 == 0 and 32 <= t.points <= max(thg.TILE_POINTS)
    assert 1 <= t.res_levels <= L and (t.res_levels == L or not grad)
    assert t.warps in thg.TILE_WARPS and t.points // 32 * t.res_levels % t.warps == 0
    assert 0 < t.smem_bytes <= thg.SMEM_LIMIT and t.smem_bytes % 16 == 0
    P = t.points
    spans = [(0, P * t.x_stride), (t.u_off, P * t.u_stride), (t.cols_off, P * t.cols_stride),
             (t.rows_off, P * t.res_stride), (t.weights_off, P * t.res_stride),
             (t.terms_off, L * D * P if grad else 0)]
    end = 0
    for off, words in spans:
        assert off % 4 == 0 and off >= end
        end = off + words
    assert end * 4 <= t.smem_bytes
    for stride, row in ((t.x_stride, D), (t.u_stride, ulen), (t.cols_stride, L * C), (t.res_stride, res_cols)):
        assert stride == 0 if row == 0 else (stride % 2 == 1 and stride >= row)
    blocks = thg.resident_blocks(t, regs)
    least = thg._layout(32, D, L, C, ulen, res_cols // t.res_levels if res_cols else 0, 1 if res_cols else L, grad, 1)
    if thg.resident_blocks(least, regs) * (least.smem_bytes + thg.SM_BLOCK_SMEM) <= thg.SM_SMEM_TARGET:
        assert 0 < blocks and blocks * (t.smem_bytes + thg.SM_BLOCK_SMEM) <= thg.SM_SMEM_TARGET


@pytest.mark.parametrize("dim", range(1, 8))
def test_tiles_fit_every_shape_the_kernels_take(dim):
    """``encode_tile`` and ``input_grad_tile`` over levels 1-32, channels
    1-8, draws K 0-4 (0: exact, 2^D columns a level), residuals on and off
    and kernels of 40 and 128 registers a thread: every tile is one the
    kernels take (``_check_tile``); a chunk holds the residual columns of
    ``res_levels`` levels."""
    for regs in (40, 128):
        for L in range(1, 33):
            for C in range(1, 9):
                _check_tile(thg.input_grad_tile(L, dim, C, regs), L, dim, C, 0, 0, True, regs)
                for K in range(5):
                    ulen, level_cols = L * K * dim, K or 1 << dim
                    for residuals in (True, False):
                        t = thg.encode_tile(L, dim, C, ulen, level_cols, residuals, regs)
                        assert residuals or t.res_levels == L
                        _check_tile(t, L, dim, C, ulen, t.res_levels * level_cols if residuals else 0, False, regs)


def test_tiles_of_the_main_path():
    """The tiles the occupancy model gives the main path's encodes at the
    register counts the card's build reported (the encode 48 a thread at
    D = 3 and 64 at D = 5, the position gradient 40 and 80): each was the
    fastest of the tiles timed at its shape in one call on the card
    (PERF.md, PR 18). The -O training encode 64 points, all 16 levels'
    residuals at once; serving 128 points; a c2f stage 128 points, 8
    levels; D-NeRF's deform forward 64 points, 4 levels' 32 columns at a
    time, the hyper forward 128 points, 2 levels' 64 columns; the position
    gradient 64 points (deform) and 96 (hyper)."""
    specs = _cli_specs()
    got = {
        "-O": thg.spec_encode_tile(specs["-O"], True, True, 48),
        "serving": thg.spec_encode_tile(specs["exact"], False, False, 48),
        "-O2 stage": thg.spec_encode_tile(specs["-O2 stage"], True, True, 48),
        "deform": thg.spec_encode_tile(specs["deform"], False, True, 48),
        "hyper": thg.spec_encode_tile(specs["hyper"], False, True, 64),
        "deform gradient": thg.input_grad_tile(16, 3, 2, 40),
        "hyper gradient": thg.input_grad_tile(16, 5, 2, 80),
    }
    assert {name: (t.points, t.warps, t.res_levels) for name, t in got.items()} == {
        "-O": (64, 8, 16), "serving": (128, 8, 16), "-O2 stage": (128, 8, 8), "deform": (64, 8, 4),
        "hyper": (128, 8, 2), "deform gradient": (64, 8, 16), "hyper gradient": (96, 8, 16)}
    assert got["-O"].res_stride == 17 and got["-O"].u_stride == 49
    assert got["deform"].res_stride == 33 and got["hyper"].res_stride == 65



def test_dispatchers_take_the_plain_versions_on_cpu():
    """CPU tensors: the encode, its autograd function and the position
    gradient run the plain versions and launch nothing."""
    js, ts = _specs(3, 1, 1)
    x = torch.from_numpy(_points(ts, seed=6))
    table = torch.from_numpy(np.random.default_rng(6).uniform(-1, 1, (ts.table_rows, 2)).astype(np.float32))
    u = torch.from_numpy(_draws(js, N, seed=6))
    before = (thg.hashgrid_encode_forward.launches, thg.hashgrid_input_grad.launches)
    for draws in (None, u):
        got = thg.hashgrid_encode_forward(table, x, ts, draws, residuals=True)
        want = thg.encode_plain(table, x, ts, draws, residuals=True)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    exact = dataclasses.replace(ts, stochastic_k=0)
    cot = torch.randn(N, ts.output_dim, generator=torch.Generator().manual_seed(0))
    assert torch.equal(thg.hashgrid_input_grad(table, x, cot, exact), thg.input_grad_plain(table, x, cot, exact))
    t, xx = table.clone().requires_grad_(), x.clone().requires_grad_()
    (thg.hashgrid_encode(t, xx, exact) * cot).sum().backward()
    assert torch.equal(xx.grad, thg.input_grad_plain(table, x, cot, exact))
    assert (thg.hashgrid_encode_forward.launches, thg.hashgrid_input_grad.launches) == before


def test_dispatchers_raise_on_other_devices():
    _, ts = _specs(3)
    meta = torch.empty((ts.table_rows, 2), device="meta")
    x = torch.empty((8, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        thg.hashgrid_encode_forward(meta, x, ts, None, residuals=False)
    with pytest.raises(ValueError, match="unsupported device"):
        thg.hashgrid_input_grad(meta, x, torch.empty((8, ts.output_dim), device="meta"), ts)


def _encode_operands(spec):
    g = torch.Generator().manual_seed(1)
    n_stoch = len(thg.stochastic_levels(spec))
    return dict(table=torch.zeros((spec.table_rows, spec.level_dim)), x01=torch.rand(64, spec.input_dim, generator=g),
                u=torch.rand(64, n_stoch, spec.stochastic_k, spec.input_dim, generator=g))


@pytest.mark.parametrize("bad", ["table dtype", "table columns", "table rows", "table strided", "table misaligned",
                                 "u shape", "u dtype", "u device", "u strided", "levels"])
def test_encode_launch_rejects_bad_operands(bad):
    """The encode kernel's wrapper raises on what the kernel does not take,
    before it builds or launches anything."""
    _, spec = _specs(3, 1, 1)
    ops = _encode_operands(spec)
    if bad == "table dtype":
        ops["table"] = ops["table"].double()
    elif bad == "table columns":
        ops["table"] = torch.zeros((spec.table_rows, 3))
    elif bad == "table rows":
        ops["table"] = ops["table"][:-1]
    elif bad == "table strided":
        ops["table"] = torch.zeros((spec.table_rows, 4))[:, ::2]
    elif bad == "table misaligned":
        ops["table"] = torch.zeros(spec.table_rows * 2 + 1)[1:].reshape(-1, 2)
    elif bad == "u shape":
        ops["u"] = ops["u"][:-1]
    elif bad == "u dtype":
        ops["u"] = ops["u"].double()
    elif bad == "u device":
        ops["u"] = ops["u"].to("meta")
    elif bad == "u strided":
        ops["u"] = ops["u"].transpose(0, 1).contiguous().transpose(0, 1)
    else:
        spec = thg.HashGridSpec.create(num_levels=33, base_resolution=2, log2_hashmap_size=11, per_level_scale=1.1)
        ops = _encode_operands(spec)
        ops["u"] = None
    with pytest.raises(ValueError):
        thg._encode_launch(ops["table"], ops["x01"], spec, ops["u"], residuals=True)


@pytest.mark.parametrize("bad", ["g shape", "table rows", "table columns", "x device"])
def test_input_grad_launch_rejects_bad_operands(bad):
    _, spec = _specs(5)
    table = torch.zeros((spec.table_rows, 2))
    x = torch.rand(64, 5, generator=torch.Generator().manual_seed(2))
    g = torch.zeros((64, spec.output_dim))
    if bad == "g shape":
        g = g[:, :-2]
    elif bad == "table rows":
        table = table[:-1]
    elif bad == "table columns":
        table = torch.zeros((spec.table_rows, 3))
    else:
        x = x.to("meta")
    with pytest.raises(ValueError):
        thg._input_grad_launch(table, x, g, spec)


def test_kernel_wrappers_import_without_nvcc(monkeypatch):
    """The wrappers import and count without nvcc; their source is one of the
    libraries the build compiles; finding nvcc fails only when asked."""
    from focnerf_tpu_torch.ops import _build, kernel_wrappers

    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    names = [f.__name__ for f in kernel_wrappers()]
    assert "hashgrid_encode_forward" in names and "hashgrid_input_grad" in names
    assert thg.hashgrid_encode_forward.launches >= 0 and thg.hashgrid_input_grad.launches >= 0
    assert "hashgrid_fwd" in _build.KERNEL_SOURCES
    path = _build.library_path("hashgrid_fwd")
    assert path.startswith(_build.BUILD_DIR) and os.path.exists(os.path.join(_build.CSRC_DIR, "hashgrid_fwd.cu"))
    if not os.path.exists("/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.find_nvcc()
