"""utils/flops.py on the CPU: tests/test_flops.py's cases as they apply to
eager torch (a Python loop of N matmuls counts N times, a backward counts
too), the random-access bytes, ``roofline`` against the H100's public peaks
and no peak for an unknown card, and the matmul FLOPs of one small
occupancy train step equal to JAX's ``count_program`` of the same step."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from focnerf_tpu.utils.flops import count_program as jcount
from focnerf_tpu_torch.utils.flops import PEAKS, count_program, note_kernel_bytes, roofline


def test_dot_flops_exact():
    c = count_program(lambda a, b: a @ b, torch.ones(64, 128), torch.ones(128, 32))
    assert c["flops"] == 2 * 64 * 128 * 32 and c["gather_bytes"] == 0 and not c["dynamic_while"]


def test_python_loop_counts_each_matmul():
    def f(a):
        for _ in range(7):
            a = a @ a
        return a

    assert count_program(f, torch.ones(32, 32))["flops"] == 7 * 2 * 32**3


def test_nested_calls_and_batched_products():
    def inner(a):
        return a @ a

    assert count_program(lambda a: inner(inner(a)), torch.ones(8, 8))["flops"] == 2 * 2 * 8**3
    c = count_program(lambda a, b: torch.bmm(a, b) + torch.addmm(torch.zeros(4, 6), a[0], b[0]),
                      torch.ones(3, 4, 5), torch.ones(3, 5, 6))
    assert c["flops"] == 3 * 2 * 4 * 5 * 6 + 2 * 4 * 5 * 6


def test_gather_and_scatter_bytes():
    tbl, idx = torch.ones(1024, 4), torch.zeros(256, dtype=torch.long)
    c = count_program(lambda t, i: t[i], tbl, idx)
    assert c["gather_bytes"] == 2 * 256 * 4 * 4 and c["flops"] == 0  # JAX's count of the same gather
    assert count_program(lambda t, i: t.index_select(0, i), tbl, idx)["gather_bytes"] == 2 * 256 * 4 * 4
    src = torch.ones(256, 4)
    assert count_program(lambda: torch.zeros(1024, 4).index_add_(0, idx, src))["gather_bytes"] == 3 * 256 * 4 * 4
    # a kernel the dispatcher cannot see reports its scatter itself
    assert count_program(lambda: note_kernel_bytes(96.0))["gather_bytes"] == 96.0
    note_kernel_bytes(1.0)  # outside a count: nothing to add to


def test_grad_counts_backward_too():
    x, w = torch.ones(32, 64), torch.ones(64, 16, requires_grad=True)

    def loss(w, x):
        return ((x @ w) ** 2).sum()

    fwd = count_program(loss, w, x)["flops"]
    both = count_program(lambda w, x: loss(w, x).backward(), w, x)["flops"]
    assert both == 2 * fwd  # dL/dw = x^T g; x needs no gradient
    x.requires_grad_()
    assert count_program(lambda w, x: loss(w, x).backward(), w, x)["flops"] == 3 * fwd
    jfwd = jcount(loss, jnp.ones((64, 16)), jnp.ones((32, 64)))["flops"]
    assert jfwd == fwd


def test_roofline_h100_peaks_and_no_default():
    x = torch.ones(64, 64)
    r = roofline(lambda a: a @ a, x, step_seconds=1e-3, device_name="NVIDIA H100 80GB HBM3")
    assert r["flops_per_step"] == 2 * 64**3
    assert r["mfu"] == pytest.approx(2 * 64**3 / 1e-3 / 989e12)
    assert r["achieved_tflops"] == pytest.approx(2 * 64**3 / 1e-3 / 1e12)
    assert PEAKS["NVIDIA H100 80GB HBM3"]["hbm_bytes_per_s"] == 3.35e12
    r = roofline(lambda a: a[torch.zeros(8, dtype=torch.long)], x, step_seconds=1e-3, steps_per_program=2,
                 device_name="NVIDIA H100 80GB HBM3")
    assert r["gather_bytes_per_step"] == 2 * 8 * 64 * 4 / 2
    assert r["hbm_gather_util"] == pytest.approx(r["gather_bytes_per_step"] / 1e-3 / 3.35e12)
    unknown = roofline(lambda a: a @ a, x, step_seconds=1e-3, device_name="some other card")
    assert unknown["mfu"] is None and unknown["hbm_gather_util"] is None
    assert roofline(lambda a: a @ a, x, step_seconds=1e-3, device_name="x", peak_flops=1e12)["mfu"] == \
        pytest.approx(2 * 64**3 / 1e-3 / 1e12)


SMALL = dict(num_levels=4, log2_hashmap_size=11, hidden_dim=16, hidden_dim_color=16, bound=1.0, use_objfeat=False,
             stochastic_corners=1, stochastic_min_size=1)
N, SLAB = 64, 8


def test_occupancy_train_step_matmul_flops_equal_jax():
    """tests/test_flops.py's train step (64 rays from z = -2 down the z axis,
    every cell occupied, slab 8, the mean squared image, Adam) at a small
    width in both packages: the MLPs' forward and backward matmuls, 3 a
    layer (the encode's input needs its gradient), the same 2*M*N*K."""
    from focnerf_tpu.models.nerf import NeRFConfig as JConfig
    from focnerf_tpu.render.renderer import render_rays_occupancy as jrender
    from focnerf_tpu.train.state import create_train_state, make_optimizer
    from focnerf_tpu_torch.models.nerf import NeRFConfig, init_nerf_params
    from focnerf_tpu_torch.render.renderer import render_rays_occupancy
    from focnerf_tpu_torch.train.state import TrainState
    from focnerf_tpu_torch.train.steps import _corner_draws

    jcfg = JConfig(**SMALL, compute_dtype=jnp.float32)
    optimizer = make_optimizer(lr=1e-2, iters=100)
    state = create_train_state(jax.random.key(0), jcfg, optimizer)
    bits = jnp.ones((1, 128**3), bool)

    def jloss(params, rng):
        o = jnp.zeros((N, 3)) + jnp.array([0.0, 0.0, -2.0])
        d = jnp.tile(jnp.array([[0.0, 0.0, 1.0]]), (N, 1))
        out = jrender(params, jcfg, o, d, bits, dt_gamma=0.0, max_steps=64, slab=SLAB, bg_color=1.0, rng=rng,
                      perturb=True)
        return jnp.mean(out["image"] ** 2)

    def jstep(state, rng):
        loss, grads = jax.value_and_grad(jloss)(state.params, rng)
        updates, _ = optimizer.update(grads, state.opt_state, state.params)
        return optax.apply_updates(state.params, updates), loss

    want = jcount(jstep, state, jax.random.key(0))["flops"]

    cfg = NeRFConfig(**SMALL, compute_dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    tstate = TrainState(init_nerf_params(g, cfg, "cpu"), lr=1e-2, iters=100)
    occ = torch.ones((1, 128**3), dtype=torch.bool)

    def step(state):
        o = torch.zeros((N, 3)) + torch.tensor([0.0, 0.0, -2.0])
        d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(N, 1)
        out = render_rays_occupancy(state.params, cfg, o, d, occ, dt_gamma=0.0, max_steps=64, slab=SLAB,
                                    bg_color=1.0, perturb=True, noise=torch.rand(N, generator=g),
                                    u=_corner_draws(g, cfg, N * SLAB, "cpu"))
        (out["image"] ** 2).mean().backward()
        state.apply_gradients()

    got = count_program(step, tstate)
    assert got["flops"] == want > 1e6
    assert got["gather_bytes"] > 0  # the table's and the bitfield's gathers, the table gradient's scatter
    assert np.isfinite(got["gather_bytes"])
