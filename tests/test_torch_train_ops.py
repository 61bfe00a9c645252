"""The training slice's ops held against their JAX twins on the CPU: the
stochastic hash encode and its table gradient (a), the composite gradients
(b), the skip field and the skip march (c), the occupancy update and the
untrained-cell marking (d).

Inputs and draws come from numpy or from the JAX package's own PRNG calls
and go through both packages; each assertion states its tolerance and why.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focnerf_tpu.models.nerf import NeRFConfig as JNeRFConfig
from focnerf_tpu.ops import composite as jcomp
from focnerf_tpu.ops import hashgrid as jhg
from focnerf_tpu.ops import marching as jmarch
from focnerf_tpu.ops import occupancy as jocc
from focnerf_tpu.ops.hashgrid_pallas import hashgrid_bwd_level
from focnerf_tpu_torch.models.nerf import NeRFConfig
from focnerf_tpu_torch.ops import composite as tcomp
from focnerf_tpu_torch.ops import hashgrid as thg
from focnerf_tpu_torch.ops import marching as tmarch
from focnerf_tpu_torch.ops import occupancy as tocc
from test_torch_model import start_torch_threads
from test_torch_ops import SMALL, _comp_data, _rays, _t

start_torch_threads()


# ------------------------------------------------- (a) stochastic hash encode
def _specs(k: int, min_size: int):
    js = dataclasses.replace(JNeRFConfig(**SMALL).grid_spec, stochastic_k=k,
                             stochastic_min_size=min_size)
    ts = dataclasses.replace(NeRFConfig(**SMALL).grid_spec, stochastic_k=k,
                             stochastic_min_size=min_size)
    return js, ts


def _points(n=300, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    x[:12] = rng.uniform(-0.5, 1.5, (12, 3))  # some outside [0, 1]
    return x


def _u(spec, n, seed=7):
    n_stoch = sum(jhg._is_stochastic_level(spec, lvl) for lvl in range(spec.num_levels))
    return np.asarray(jax.random.uniform(jax.random.key(seed), (n, n_stoch, spec.stochastic_k, 3)))


# (K, stochastic_min_size): -O's all-levels K=1; hashed-only (mixed layout);
# K=2 hashed-only
STOCH = [(1, 1), (1, 0), (2, 0)]


@pytest.mark.parametrize("k,min_size", STOCH)
def test_stochastic_encode_matches_jax(k, min_size):
    js, ts = _specs(k, min_size)
    x = _points()
    u = _u(js, x.shape[0])
    table = np.random.default_rng(3).uniform(-1, 1, (js.table_rows, js.level_dim)).astype(np.float32)
    jout, jrows, jw = jhg._encode_impl(jnp.asarray(table), jnp.asarray(x), js, jnp.asarray(u))
    tout, trows, tw = thg.hashgrid_encode_forward(_t(table), _t(x), ts, _t(u), residuals=True)
    assert thg.col_levels(ts, True) == tuple(
        lvl for lvl, (_, n) in enumerate(jhg._col_layout(js)) for _ in range(n)
    )
    inside = ~((x < 0) | (x > 1)).any(-1)
    # integer rows: identical wherever the point is inside the unit cube (the
    # port moves outside points to the origin, JAX wraps their uint32 coords;
    # both give them weight 0)
    np.testing.assert_array_equal(trows.numpy()[inside], np.asarray(jrows)[inside])
    # weights: 1/K, or the same float32 products for exact levels (1 ulp)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)
    # out: the same products; JAX sums exact levels through a selection matmul
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
    assert np.all(tout.numpy()[~inside] == 0)


@pytest.mark.parametrize("stochastic", [True, False], ids=["stochastic", "exact"])
def test_table_grad_matches_jax_grad(stochastic):
    js, ts = _specs(1, 1) if stochastic else _specs(0, 0)
    x = _points(n=400, seed=4)
    table = np.random.default_rng(5).uniform(-1, 1, (js.table_rows, js.level_dim)).astype(np.float32)
    cot = np.random.default_rng(6).normal(size=(x.shape[0], js.output_dim)).astype(np.float32)
    key = jax.random.key(11) if stochastic else None

    def f(tab):
        return jnp.sum(jhg.hashgrid_encode(tab, jnp.asarray(x), js, rng=key) * cot)

    want = np.asarray(jax.grad(f)(jnp.asarray(table)))  # CPU: the exact fp32 sort backward
    u = None
    if stochastic:  # the draw hashgrid_encode makes from its rng
        n_stoch = len(thg.stochastic_levels(ts))
        u = _t(jax.random.uniform(key, (x.shape[0], n_stoch, 1, 3)))
    tab = _t(table).requires_grad_()
    (thg.hashgrid_encode(tab, _t(x), ts, u) * _t(cot)).sum().backward()
    got = tab.grad.numpy()
    # fp32 sums of the same products in another order (index_add_ vs sorted
    # scatter): a few ulp of the largest row sum
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    untouched = want == 0
    assert untouched.any() and np.all(got[untouched] == 0)


@pytest.mark.parametrize(
    "size,m", [(524288, 4096), (13824, 10000), (4920, 50000)],
    ids=["hashed", "dense", "collisions"],
)
def test_table_grad_matches_pallas_level_kernel(size, m):
    """One level of the scatter against the TPU kernel it replaces
    (interpret mode, exact bf16 variant) at tests/test_hashgrid_pallas.py's
    sizes, and against np.add.at."""
    rng = np.random.default_rng(size)
    r = rng.integers(0, size, m).astype(np.int32)
    c = rng.normal(size=(m, 2)).astype(np.float32)
    w = rng.uniform(0, 1, (m, 1)).astype(np.float32)
    w[::17] = 0.0  # zero-weight entries (points outside the cube) are neutral
    got = thg.hashgrid_table_grad(_t(r[:, None]), _t(w), _t(c), (0,), size).numpy()
    ref = np.zeros((size, 2), np.float32)
    np.add.at(ref, r, w * c)
    scale = np.abs(ref).max()
    # fp32 index_add_ vs np.add.at: the same sums in another order
    assert np.abs(got - ref).max() <= 1e-5 * scale
    pallas = np.asarray(hashgrid_bwd_level(jnp.asarray(r), jnp.asarray(w * c), size=size,
                                           interpret=True, use_int8=False))
    # the Pallas kernel rounds contributions to bf16: its test's 1% bound
    assert np.abs(got - pallas).max() <= 0.01 * scale
    untouched = np.setdiff1d(np.arange(size), r[w[:, 0] != 0])
    assert np.all(got[untouched] == 0)


# --------------------------------------------------- (b) composite gradients
@pytest.mark.parametrize("thresh", [0.0, 1e-4])
def test_composite_grads_match_jax(thresh):
    sig, rgb, dts, ts = _comp_data(n=60, seed=5)
    n = sig.shape[0]
    rng = np.random.default_rng(8)
    bg = rng.uniform(0, 1, (n, 3)).astype(np.float32)  # per-pixel, as in training
    gi, gw, gd = (rng.normal(size=s).astype(np.float32) for s in ((n, 3), (n,), (n,)))

    def f(s, c):
        out = jcomp.composite_rays(s, c, jnp.asarray(dts), ts=jnp.asarray(ts),
                                   bg_color=jnp.asarray(bg), T_thresh=thresh)
        return jnp.sum(out["image"] * gi) + jnp.sum(out["weights_sum"] * gw) + jnp.sum(out["depth"] * gd)

    jds, jdc = jax.grad(f, argnums=(0, 1))(jnp.asarray(sig), jnp.asarray(rgb))
    s, c = _t(sig).requires_grad_(), _t(rgb).requires_grad_()
    img, ws, depth = tcomp.composite_rays_fused(s, c, _t(dts), _t(ts), bg_color=_t(bg), T_thresh=thresh)
    ((img * _t(gi)).sum() + (ws * _t(gw)).sum() + (depth * _t(gd)).sum()).backward()
    # the wrapper of the backward kernel, on CPU tensors its plain version
    wds, wdc = tcomp.composite_rays_fused_backward(
        _t(sig), _t(rgb), _t(dts), _t(ts), _t(bg), (img.detach(), ws.detach(), depth.detach()),
        (_t(gi), _t(gw), _t(gd)), T_thresh=thresh,
    )
    assert tcomp.composite_rays_fused_backward.launches == 0
    for got in (s.grad, wds):
        assert torch.isfinite(got).all()  # inf sigma spikes stay finite
        # fp32 autodiff of the same formula; reverse cumsums in another order
        np.testing.assert_allclose(got.numpy(), np.asarray(jds), rtol=1e-5, atol=1e-6)
    for got in (c.grad, wdc):
        np.testing.assert_allclose(got.numpy(), np.asarray(jdc), rtol=1e-5, atol=1e-7)


# ------------------------------------------------ (c) skip field and skip march
@pytest.mark.parametrize("gs,share", [(16, 0.02), (32, 0.002), (32, 0.3)])
def test_skip_field_matches_jax(gs, share):
    rng = np.random.default_rng(gs)
    bits = rng.uniform(size=(2, gs**3)) < share
    want = np.asarray(jocc.occupancy_skip_field(jnp.asarray(bits), grid_size=gs))
    got = tocc.occupancy_skip_field(_t(bits), grid_size=gs)
    assert got.dtype == torch.uint8 and len(np.unique(want)) > 2
    np.testing.assert_array_equal(got.numpy(), want)  # integer codes: exact


@pytest.mark.parametrize(
    "bound,dt_gamma,perturb",
    [(1.0, 1 / 128, True), (2.0, 1 / 128, True), (1.0, 0.0, True), (1.0, 1 / 128, False)],
)
def test_march_rays_skip_matches_jax(bound, dt_gamma, perturb):
    from focnerf_tpu.core.geometry import near_far_from_aabb as jnear_far

    o, d = _rays(n=96, radius=2.5 * bound)
    aabb = jnp.asarray([-bound] * 3 + [bound] * 3, jnp.float32)
    jn, jf = jnear_far(jnp.asarray(o), jnp.asarray(d), aabb)
    rng = np.random.default_rng(1)
    cas = jocc.cascade_count(bound)
    bits = rng.uniform(size=(cas, 128**3)) < 0.02  # sparse: leaps of many sizes
    skip = jocc.occupancy_skip_field(jnp.asarray(bits))
    key = jax.random.key(3)
    kw = dict(bound=bound, dt_gamma=dt_gamma, max_steps=1024, slab=48)
    jm = jmarch.march_rays_skip(jnp.asarray(o), jnp.asarray(d), jn, jf, skip, rng=key,
                                perturb=perturb, **kw)
    noise = _t(jax.random.uniform(key, (o.shape[0],))) if perturb else None  # JAX's own draw
    tm = tmarch.march_rays_skip(_t(o), _t(d), _t(jn), _t(jf), _t(skip), noise=noise, **kw)

    jvalid, tvalid = np.asarray(jm.valid), tm.valid.numpy()
    assert jvalid.sum() > 0 and tm.iters > 0
    # a landing on a cell boundary can fall in the other cell when log/pow
    # round differently (libm vs XLA), which shifts that ray's later samples:
    # the bound of test_march_rays_matches_jax
    differ = (jvalid != tvalid).any(-1) | (np.asarray(jm.count) != tm.count.numpy())
    assert differ.sum() <= max(1, len(differ) // 50), int(differ.sum())
    same = ~differ
    np.testing.assert_allclose(tm.ts.numpy()[same], np.asarray(jm.ts)[same], rtol=2e-6)
    np.testing.assert_allclose(tm.dts.numpy()[same], np.asarray(jm.dts)[same], rtol=2e-6)


# ----------------------------------------- (d) occupancy update and marking
def _density(x):
    """A smooth non-negative density, the same formula in both packages."""
    lib = jnp if isinstance(x, jax.Array) else torch
    return 12.0 * (1.0 + lib.sin(3.0 * x[:, 0]) * lib.cos(2.0 * x[:, 1])) * lib.exp(-x[:, 2] ** 2)


def _grid(cas, gs, seed=0):
    rng = np.random.default_rng(seed)
    grid = rng.uniform(0, 20, (cas, gs**3)).astype(np.float32)
    grid[rng.uniform(size=grid.shape) < 0.5] = 0.0
    grid[rng.uniform(size=grid.shape) < 0.1] = -1.0  # untrained cells stay -1
    return grid


@pytest.mark.parametrize("full", [True, False], ids=["full", "partial"])
def test_update_occupancy_matches_jax(full):
    gs, bound = 16, 2.0
    cas = jocc.cascade_count(bound)
    grid = _grid(cas, gs)
    jst = jocc.OccupancyState(jnp.asarray(grid), jnp.float32(grid.clip(0).mean()), jnp.int32(20))
    tst = tocc.OccupancyState(_t(grid), torch.tensor(grid.clip(0).mean()), torch.tensor(20))
    key = jax.random.key(5)
    jnew = jocc.update_occupancy(jst, _density, key, bound=bound, grid_size=gs, chunk=1024, full=full)
    # the draws update_occupancy makes from its rng, rebuilt from the same keys
    n_cells, n = gs**3, gs**3 // 4
    draws = {"jitter": [], "rand_idx": [], "u": []}
    for c in range(cas):
        kc = jax.random.fold_in(key, c)
        if full:
            draws["jitter"].append(jax.random.uniform(kc, (n_cells, 3)))
        else:
            k1, k2, k3 = jax.random.split(kc, 3)
            draws["rand_idx"].append(jax.random.randint(k1, (n,), 0, n_cells))
            draws["u"].append(jax.random.uniform(k2, (n,)))
            draws["jitter"].append(jax.random.uniform(k3, (2 * n, 3)))
    draws = {k: torch.from_numpy(np.stack(v)).to(torch.int64 if k == "rand_idx" else torch.float32)
             for k, v in draws.items() if v}
    tnew = tocc.update_occupancy(tst, _density, draws, bound=bound, grid_size=gs, chunk=1000)

    want, got = np.asarray(jnew.density_grid), tnew.density_grid.numpy()
    assert int(tnew.iter_density) == 21
    np.testing.assert_array_equal(got == -1, want == -1)  # untrained stays untrained
    once = np.ones(grid.shape, bool)
    if not full:
        # a cell drawn twice takes one of its two fresh values (scatter order
        # is unspecified on both sides): compare the cells drawn at most once
        for c in range(cas):
            d = draws["rand_idx"][c].numpy()
            cdf = np.cumsum(grid[c] > 0)
            occ_idx = np.clip(np.searchsorted(cdf, draws["u"][c].numpy() * max(cdf[-1], 1), "left"),
                              0, n_cells - 1)
            hits = np.bincount(np.concatenate([d, occ_idx]), minlength=n_cells)
            once[c] = hits <= 1
        assert once.mean() > 0.5
    # the same fp32 density of the same jittered points; max/decay exact
    np.testing.assert_allclose(got[once], want[once], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tnew.mean_density), float(jnew.mean_density),
                               rtol=1e-5 if full else 2e-2)


def test_mark_untrained_grid_matches_jax():
    from focnerf_tpu_torch.core.camera import rand_poses

    gs, bound = 16, 2.0
    cas = jocc.cascade_count(bound)
    grid = _grid(cas, gs, seed=1).clip(0, None)
    poses = rand_poses(np.random.default_rng(2), 3, radius=3.0)
    intr = np.array([40.0, 40.0, 16.0, 16.0], np.float32)
    jst = jocc.OccupancyState(jnp.asarray(grid), jnp.float32(0), jnp.int32(0))
    tst = tocc.OccupancyState(_t(grid), torch.tensor(0.0), torch.tensor(0))
    want = np.asarray(jocc.mark_untrained_grid(jst, jnp.asarray(poses), intr, bound=bound,
                                               grid_size=gs, chunk=1024).density_grid)
    got = tocc.mark_untrained_grid(tst, poses, intr, bound=bound, grid_size=gs,
                                   chunk=1000).density_grid.numpy()
    assert 0 < (want == -1).mean() < 1
    # frustum comparisons of the same fp32 products: a cell exactly on a
    # frustum plane may flip; none does on these poses
    np.testing.assert_array_equal(got, want)


# ------------------------------------------- (e) the kernel wrappers' host side
@pytest.mark.parametrize("T,G", [(1, 1), (16, 16), (17, 32), (128, 32), (200, 32)])
def test_composite_backward_group_width(T, G):
    """Lanes per ray of the backward kernel: the power of two >= T, at most 32."""
    assert tcomp.group_width(T) == G


def _table_grad_operands(n=64, J=16, C=2):
    return dict(rows=torch.zeros((n, J), dtype=torch.int32), weights=torch.ones((n, J)),
                g=torch.zeros((n, J * C)), col_level=torch.arange(J, dtype=torch.int32))


@pytest.mark.parametrize("bad", ["rows dtype", "weights dtype", "weights device", "g shape",
                                 "g strided", "col_level shape", "col_level dtype", "channels"])
def test_table_grad_launch_rejects_bad_operands(bad):
    """The kernel's wrapper raises on what the kernel does not take, before it
    builds or launches anything."""
    ops = _table_grad_operands()
    C = 2
    if bad == "rows dtype":
        ops["rows"] = ops["rows"].long()
    elif bad == "weights dtype":
        ops["weights"] = ops["weights"].double()
    elif bad == "weights device":
        ops["weights"] = ops["weights"].to("meta")
    elif bad == "g shape":
        ops["g"] = ops["g"][:-1]
    elif bad == "g strided":
        ops["g"] = torch.zeros((64, 64))[:, ::2]
    elif bad == "col_level shape":
        ops["col_level"] = ops["col_level"][:-1]
    elif bad == "col_level dtype":
        ops["col_level"] = ops["col_level"].long()
    else:
        C = 3  # 32 cotangent columns are not whole levels of 3 channels
    with pytest.raises(ValueError):
        thg._table_grad_launch(**ops, n_rows=100, C=C)


def test_table_grad_rejects_other_devices():
    ops = _table_grad_operands()
    meta = {k: v.to("meta") for k, v in ops.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        thg.hashgrid_table_grad(meta["rows"], meta["weights"], meta["g"], tuple(range(16)), 100)


def _composite_operands(n=8, T=16):
    sig, rgb, dts, ts = (_t(a) for a in _comp_data(n=n, t=T, spike=False))
    outs = (torch.zeros(n, 3), torch.zeros(n), torch.zeros(n))
    return dict(sigmas=sig, rgbs=rgb, deltas=dts, ts=ts, bg_color=1.0, outputs=outs,
                grads=tuple(torch.ones_like(o) for o in outs))


@pytest.mark.parametrize("bad", ["sigmas dtype", "rgbs shape", "ts device", "deltas strided",
                                 "g_image shape", "weights_sum dtype", "bg shape"])
def test_composite_backward_launch_rejects_bad_operands(bad):
    """The backward kernel's wrapper raises on what the kernel does not take,
    before it builds or launches anything."""
    ops = _composite_operands()
    if bad == "sigmas dtype":
        ops["sigmas"] = ops["sigmas"].double()
    elif bad == "rgbs shape":
        ops["rgbs"] = ops["rgbs"][:, :-1]
    elif bad == "ts device":
        ops["ts"] = ops["ts"].to("meta")
    elif bad == "deltas strided":
        ops["deltas"] = torch.zeros(8, 32)[:, ::2]
    elif bad == "g_image shape":
        ops["grads"] = (torch.ones(8, 4),) + ops["grads"][1:]
    elif bad == "weights_sum dtype":
        ops["outputs"] = (ops["outputs"][0], ops["outputs"][1].half(), ops["outputs"][2])
    else:
        ops["bg_color"] = torch.ones(7, 3)
    with pytest.raises(ValueError):
        tcomp._backward_launch(**ops, density_scale=1.0, T_thresh=1e-4)


def test_composite_backward_rejects_other_devices():
    ops = {k: v.to("meta") if torch.is_tensor(v) else v for k, v in _composite_operands().items()}
    ops["outputs"] = tuple(o.to("meta") for o in ops["outputs"])
    ops["grads"] = tuple(o.to("meta") for o in ops["grads"])
    with pytest.raises(ValueError, match="unsupported device"):
        tcomp.composite_rays_fused_backward(**ops)
