"""The hash encode's position gradient (ops/hashgrid.py ``HashGridEncode``
with points that require grad, ``hashgrid_input_grad``) held against
``jax.grad`` of the JAX package's ``hashgrid_encode(..., input_grads=True)``
on the CPU: D = 3 and D = 5, dense and hashed levels, points outside the
unit cube; and the table gradient of the same backward."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_model  # noqa: E402,F401  (starts torch's pool first)

from focnerf_tpu.ops import hashgrid as jhg  # noqa: E402
from focnerf_tpu_torch.ops import hashgrid as thg  # noqa: E402

N = 400


def _specs(dim, log2):
    kw = dict(num_levels=4, level_dim=2, base_resolution=4, log2_hashmap_size=log2,
              desired_resolution=64, input_dim=dim)
    return jhg.HashGridSpec.create(**kw), thg.HashGridSpec.create(**kw)


def _inputs(spec, seed, lo=-0.1, hi=1.1):
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1, 1, (spec.table_rows, spec.level_dim)).astype(np.float32)
    x = rng.uniform(lo, hi, (N, spec.input_dim)).astype(np.float32)
    cot = rng.normal(size=(N, spec.output_dim)).astype(np.float32)
    return table, x, cot


def _jax_grads(jspec, table, x, cot):
    def f(t, xx):
        return jnp.sum(jhg.hashgrid_encode(t, xx, jspec, input_grads=True) * cot)

    out = jhg.hashgrid_encode(jnp.asarray(table), jnp.asarray(x), jspec, input_grads=True)
    gt, gx = jax.grad(f, argnums=(0, 1))(jnp.asarray(table), jnp.asarray(x))
    return np.asarray(out), np.asarray(gt), np.asarray(gx)


def _port_grads(tspec, table, x, cot):
    tt = torch.from_numpy(table).requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    out = thg.hashgrid_encode(tt, tx, tspec)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), tt.grad.numpy(), tx.grad.numpy()


# (dim, log2 table size): at 2^8 every D = 5 level and all but the coarsest
# D = 3 level hash; at 2^11 D = 3 keeps two dense levels
@pytest.mark.parametrize("dim,log2", [(3, 8), (3, 11), (5, 8), (5, 11)])
def test_position_and_table_gradient_match_jax(dim, log2):
    jspec, tspec = _specs(dim, log2)
    assert any(tspec.hashed) and (dim == 5 or not all(tspec.hashed))
    table, x, cot = _inputs(tspec, seed=dim * 100 + log2)
    jout, jgt, jgx = _jax_grads(jspec, table, x, cot)
    tout, tgt, tgx = _port_grads(tspec, table, x, cot)
    # fp32: the same weights and products, summed in another order; the
    # position gradient multiplies by the finest level's scale (63)
    np.testing.assert_allclose(tout, jout, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tgx, jgx, rtol=0, atol=2e-6 * np.abs(jgx).max())
    np.testing.assert_allclose(tgt, jgt, rtol=0, atol=1e-5)
    oob = ((x < 0) | (x > 1)).any(-1)
    assert 0.1 < oob.mean() < 0.9
    assert np.all(tgx[oob] == 0.0) and np.all(jgx[oob] == 0.0)  # exactly 0 outside
    assert np.abs(tgx[~oob]).min(axis=-1).max() > 0


def test_input_grad_recomputes_rows_and_skips_draws():
    """``HashGridEncode``'s backward, which keeps the forward's rows for the
    table gradient, recomputes them for the position gradient: its gradient
    equals ``hashgrid_input_grad`` from the points alone, also when
    ``grad_levels`` keeps only some levels' rows; an encode with a point
    gradient draws no corners."""
    import dataclasses

    _, tspec = _specs(3, 8)
    table, x, cot = _inputs(tspec, seed=5, lo=0.0, hi=1.0)
    tt, tx, g = torch.from_numpy(table), torch.from_numpy(x), torch.from_numpy(cot)
    want = thg.hashgrid_input_grad(tt, tx, g, tspec)
    for spec in (tspec, dataclasses.replace(tspec, grad_levels=(1, 3))):
        xx = tx.clone().requires_grad_()
        thg.HashGridEncode.apply(tt.clone().requires_grad_(), xx, None, spec).backward(g)
        assert torch.equal(xx.grad, want)
    stoch = dataclasses.replace(tspec, stochastic_k=1)
    u = torch.rand(N, len(thg.stochastic_levels(stoch)), 1, 3)
    xg = tx.clone().requires_grad_()
    exact = thg.hashgrid_encode(tt, tx, tspec)
    assert torch.equal(thg.hashgrid_encode(tt, xg, stoch, u).detach(), exact)
    with pytest.raises(ValueError, match="exact encode"):
        thg.HashGridEncode.apply(tt, xg, u, stoch)
