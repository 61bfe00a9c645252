"""The port's field (d) held against the JAX field on the CPU, through
``interop.params_from_jax``: fp32 tight, then bf16 loose."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focnerf_tpu.models import nerf as jnerf
from focnerf_tpu.ops.activation import trunc_exp as jtrunc_exp
from focnerf_tpu_torch import interop
from focnerf_tpu_torch.models import nerf as tnerf
from focnerf_tpu_torch.ops.activation import trunc_exp

SMALL = dict(num_levels=4, log2_hashmap_size=13, hidden_dim=16, hidden_dim_color=16, bound=1.0)


def start_torch_threads():
    """Start torch's intra-op thread pool before this process runs any JAX
    computation. A pool first started after XLA:CPU has run was seen to
    compute one chunk of its first parallel op (an exp) with ~1e-4 error,
    in about 3% of fresh processes; started first, it never did (0 of 240).

    Under pytest-xdist each worker takes its share of the cores: with every
    worker's pool at full width, W workers on C cores run W x C spinning
    threads, and a test takes several times its time alone."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 0)
    if workers > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    torch.exp(torch.zeros(1 << 20)).sum()


start_torch_threads()


def make_jax_params(jcfg, seed=0, grid_scale=1.0):
    """JAX-initialized params as numpy, with the table widened to
    U(-grid_scale, grid_scale) so the features are far from zero."""
    params = jax.tree.map(np.array, jnerf.init_nerf_params(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed)
    params["grid"] = rng.uniform(-grid_scale, grid_scale, params["grid"].shape).astype(np.float32)
    if "bg_grid" in params:
        params["bg_grid"] = rng.uniform(-1, 1, params["bg_grid"].shape).astype(np.float32)
    return params


def _inputs(n=64, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 8, 3)).astype(np.float32)
    d = rng.normal(size=(n, 8, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    feat = rng.normal(size=(144,)).astype(np.float32)
    return x, d, feat


# (rtol, atol) per dtype, with the reason:
#  fp32: the same products summed in another order -> a few ulp, amplified
#        by exp in sigma;
#  bf16: both sides round the same operands to bf16 and sum their products
#        in fp32, so they differ only where a 1-ulp difference in an fp32 sum
#        rounds a hidden unit to the neighbouring bf16 value (~0.4% of it).
#        Measured on these inputs: 1.2e-7 at most, i.e. no such flip; the
#        bound leaves room for a few.
TOL = {"float32": (2e-5, 2e-6), "bfloat16": (5e-3, 5e-4)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_field_matches_jax(dtype):
    jcfg = jnerf.NeRFConfig(**SMALL, compute_dtype=getattr(jnp, dtype))
    tcfg = tnerf.NeRFConfig(**SMALL, compute_dtype=getattr(torch, dtype))
    jp = make_jax_params(jcfg)
    tp = interop.params_from_jax(jp, tcfg, "cpu")
    x, d, feat = _inputs()
    rtol, atol = TOL[dtype]

    jsig, jgeo = jnerf.density_fn(jp, jcfg, jnp.asarray(x))
    tsig, tgeo = tnerf.density_fn(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(tsig.numpy(), np.asarray(jsig), rtol=rtol, atol=atol)
    np.testing.assert_allclose(tgeo.numpy(), np.asarray(jgeo), rtol=rtol, atol=atol)

    jobj = jnerf.encode_objfeat(jp, jcfg, jnp.asarray(feat))
    tobj = tnerf.encode_objfeat(tp, tcfg, torch.from_numpy(feat))
    np.testing.assert_allclose(tobj.numpy(), np.asarray(jobj), rtol=rtol, atol=atol)

    # color from the SAME geo features on both sides, so only color_fn differs
    jrgb = jnerf.color_fn(jp, jcfg, jnp.asarray(d), jgeo, jobj)
    trgb = tnerf.color_fn(tp, tcfg, torch.from_numpy(d), torch.from_numpy(np.array(jgeo)),
                          torch.from_numpy(np.array(jobj)))
    np.testing.assert_allclose(trgb.numpy(), np.asarray(jrgb), rtol=rtol, atol=atol)


def test_background_fn_matches_jax():
    jcfg = jnerf.NeRFConfig(**SMALL, bg_radius=4.0, compute_dtype=jnp.float32)
    tcfg = tnerf.NeRFConfig(**SMALL, bg_radius=4.0, compute_dtype=torch.float32)
    jp = make_jax_params(jcfg)
    tp = interop.params_from_jax(jp, tcfg, "cpu")
    rng = np.random.default_rng(3)
    sph = rng.uniform(-1, 1, (64, 2)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    want = jnerf.background_fn(jp, jcfg, jnp.asarray(sph), jnp.asarray(d))
    got = tnerf.background_fn(tp, tcfg, torch.from_numpy(sph), torch.from_numpy(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-6)  # fp32 order


def test_trunc_exp_value_and_clamped_grad():
    x = np.array([-30.0, -1.0, 0.0, 2.0, 20.0, 80.0], np.float32)
    jg = jax.grad(lambda v: jtrunc_exp(v).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = trunc_exp(xt)
    y.sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.exp(x), rtol=1e-6)  # fp32 exp
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=1e-6)


def test_interop_rejects_wrong_shapes_and_roundtrips_config():
    jcfg = jnerf.NeRFConfig(**SMALL)
    tcfg = tnerf.NeRFConfig(**SMALL)
    jp = make_jax_params(jcfg)
    jp["sigma_net"][0] = jp["sigma_net"][0][:-1]
    with pytest.raises(ValueError, match="sigma_net"):
        interop.params_from_jax(jp, tcfg, "cpu")
    d = interop.config_to_dict(tcfg)
    assert interop.config_from_dict(d) == tcfg
    assert d["compute_dtype"] == "bfloat16" and d["__class__"] == "NeRFConfig"


def test_init_is_seeded_and_shaped():
    cfg = tnerf.NeRFConfig(**SMALL)
    a = tnerf.init_nerf_params(torch.Generator().manual_seed(5), cfg, "cpu")
    b = tnerf.init_nerf_params(torch.Generator().manual_seed(5), cfg, "cpu")
    assert torch.equal(a["grid"], b["grid"]) and a["grid"].abs().max() <= 1e-4
    for name, dims in cfg.net_dims().items():
        assert [tuple(w.shape) for w in a[name]] == list(zip(dims[:-1], dims[1:]))
        assert float(a[name][0].abs().max()) <= dims[0] ** -0.5
