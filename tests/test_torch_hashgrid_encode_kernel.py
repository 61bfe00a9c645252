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
        assert (lt.offset[lvl], lt.size[lvl], lt.res1[lvl], bool(lt.hashed[lvl])) == (
            js.offsets[lvl], js.level_size(lvl), js.resolutions[lvl] + 1, js.hashed[lvl])
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


def test_level_table_struct_matches_the_kernel_source():
    """``_LevelTable``'s fields are csrc/hashgrid_fwd.cu's ``LevelTable``
    members, in order, all 4-byte (no padding on either side)."""
    with open(os.path.join(ROOT, "focnerf_tpu_torch", "csrc", "hashgrid_fwd.cu")) as f:
        body = re.search(r"struct LevelTable \{(.*?)\};", f.read(), re.S).group(1)
    members = re.findall(r"^\s*(?:int|float|uint32_t)\s+(\w+)(?:\[kMaxLevels\])?;", body, re.M)
    assert members == [name for name, _ in thg._LevelTable._fields_]
    assert ctypes.sizeof(thg._LevelTable) == 7 * 4 + 7 * 4 * thg._MAX_LEVELS


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
