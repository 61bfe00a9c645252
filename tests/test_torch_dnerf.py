"""The D-NeRF fields (models/dnerf.py) held against the JAX package's on the
CPU: sigma, geo features, rgb and aux of the deform, basis and hyper
variants from the same params (``interop.dnerf_params_from_jax``), fp32
tight and bf16 loose, and the gradient of every parameter in fp32 (the
deformation and hyper nets learn only through the encode's position
gradient)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_model  # noqa: E402,F401  (starts torch's pool first)

from focnerf_tpu.models import dnerf as jdn  # noqa: E402
from focnerf_tpu_torch import interop  # noqa: E402
from focnerf_tpu_torch.models import dnerf as tdn  # noqa: E402
from focnerf_tpu_torch.train.state import param_leaves  # noqa: E402

VARIANTS = ("deform", "basis", "hyper")
SMALL_DN = dict(num_levels=4, log2_hashmap_size=11, hidden_dim=16, hidden_dim_color=16, deform_layers=3,
                deform_hidden=16, bound=1.0, use_objfeat=False)
# fp32: the same products summed in another order, amplified by exp in sigma
# and, for the warped points, by the fine levels' scale; bf16: a 1-ulp fp32
# difference may round a hidden unit to the neighbouring bf16 value
TOL = {"float32": (2e-5, 2e-6), "bfloat16": (5e-3, 5e-4)}
# gradients in fp32, against each leaf's largest entry, from params with
# JAX's initial warp and the two finest levels at 0 (make_dnerf_params(...,
# warp=1, fine=0)). The warped (or lifted) points come out of an MLP and
# carry 1-ulp differences (~6e-8 in [0, 1]); the finest level (scale 2027 at
# bound 1) turns them into ~1.2e-4 differences of its interpolation weights,
# hence of its table rows' gradient: measured 2.8e-4. A larger warp, or fine
# levels that carry features, pass the same differences on to the
# deformation net's gradient through the position gradient (1e-3 to 2e-2
# measured); tests/test_torch_hashgrid_input_grads.py holds the position
# gradient at every level on shared points. Everything else: 1.7e-5 measured.
GRAD_TOL = {"grid": 1e-3, "other": 5e-5}


def configs(variant, dtype="float32"):
    return (jdn.DNeRFConfig(variant=variant, **SMALL_DN, compute_dtype=getattr(jnp, dtype)),
            tdn.DNeRFConfig(variant=variant, **SMALL_DN, compute_dtype=getattr(torch, dtype)))


def make_dnerf_params(jcfg, seed=0, warp=20.0, fine=0.02):
    """JAX-initialized D-NeRF params as numpy: a visible object (table
    U(-1, 1), the two finest levels scaled by ``fine``, sigma's first unit
    x4) and the deformation (hyper) net's last layer scaled by ``warp``
    (hyper: a quarter of it), large enough by default to move the samples
    across cells."""
    p = jax.tree.map(np.array, jdn.init_dnerf_params(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed)
    p["grid"] = rng.uniform(-1, 1, p["grid"].shape).astype(np.float32)
    spec = tdn.DNeRFConfig(**{f: getattr(jcfg, f) for f in ("variant", "num_levels", "level_dim",
                                                              "base_resolution", "log2_hashmap_size",
                                                              "bound", "hyper_dim")}).field_spec
    p["grid"][spec.offsets[2]:] *= fine
    p["sigma_net"][-1][:, 0] *= 4.0
    if "deform_net" in p:
        p["deform_net"][-1] *= warp
    if "hyper_net" in p:
        p["hyper_net"][-1] *= warp / 4.0
    return p


def _inputs(seed=1, n=48, s=8):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, s, 3)).astype(np.float32)
    d = rng.normal(size=(n, s, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return x, d


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_field_matches_jax(variant, dtype):
    jcfg, tcfg = configs(variant, dtype)
    jp = make_dnerf_params(jcfg)
    tp = interop.dnerf_params_from_jax(jp, tcfg, "cpu")
    assert sorted(tp) == sorted(jp)
    x, d = _inputs()
    rtol, atol = TOL[dtype]
    for t in (0.0, 0.37, 1.0):
        js, jrgb, jaux = jdn.dnerf_field(jp, jcfg, jnp.asarray(x), jnp.asarray(d), jnp.float32(t))
        ts, trgb, taux = tdn.dnerf_field(tp, tcfg, torch.from_numpy(x), torch.from_numpy(d), torch.tensor(t))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=rtol, atol=atol)
        np.testing.assert_allclose(trgb.numpy(), np.asarray(jrgb), rtol=rtol, atol=atol)
        assert sorted(taux) == sorted(jaux)
        for k in jaux:
            np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]), rtol=rtol, atol=atol)
    if variant == "deform":
        assert float(np.abs(np.asarray(jaux["deform"])).mean()) > 0.01  # the warp moves the samples


@pytest.mark.parametrize("variant", VARIANTS)
def test_field_gradients_match_jax(variant):
    """d(sum(c1 * sigma) + sum(c2 * rgb) + mean|dx|)/d(every param) in fp32."""
    jcfg, tcfg = configs(variant)
    jp = make_dnerf_params(jcfg, seed=2, warp=1.0, fine=0.0)
    x, d = _inputs(seed=3, n=32)
    rng = np.random.default_rng(4)
    c1 = rng.normal(size=x.shape[:-1]).astype(np.float32)
    c2 = rng.normal(size=x.shape).astype(np.float32)

    def jloss(p):
        s, rgb, aux = jdn.dnerf_field(p, jcfg, jnp.asarray(x), jnp.asarray(d), jnp.float32(0.6))
        extra = jnp.mean(jnp.abs(aux["deform"])) if "deform" in aux else 0.0
        return jnp.sum(c1 * jnp.log1p(s)) + jnp.sum(c2 * rgb) + extra

    jg = jax.grad(jloss)(jax.tree.map(jnp.asarray, jp))
    tp = interop.dnerf_params_from_jax(jp, tcfg, "cpu")
    for w in param_leaves(tp):
        w.requires_grad_(True)
    s, rgb, aux = tdn.dnerf_field(tp, tcfg, torch.from_numpy(x), torch.from_numpy(d), 0.6)
    loss = (torch.from_numpy(c1) * torch.log1p(s)).sum() + (torch.from_numpy(c2) * rgb).sum()
    if "deform" in aux:
        loss = loss + aux["deform"].abs().mean()
    loss.backward()
    check_grads(tp, jg, variant)
    net = {"deform": "deform_net", "hyper": "hyper_net", "basis": "basis_net"}[variant]
    assert all(np.abs(np.asarray(a)).max() > 0 for a in jg[net])  # the net learns


def check_grads(tp, jgrads, variant):
    """Every leaf's gradient in the port's params ``tp`` (tensors whose
    ``.grad`` is set) against the JAX gradient pytree ``jgrads``, at
    GRAD_TOL (the table's looser where its points pass through an MLP)."""
    for key, value in tp.items():
        want = jgrads[key] if isinstance(jgrads[key], list) else [jgrads[key]]
        got = value if isinstance(value, list) else [value]
        assert len(got) == len(want)
        kind = "grid" if key == "grid" and variant != "basis" else "other"
        for g, w in zip(got, want):
            w = np.asarray(w)
            np.testing.assert_allclose(g.grad.numpy(), w, rtol=0, atol=GRAD_TOL[kind] * max(np.abs(w).max(), 1e-30),
                                       err_msg=key)


def test_dnerf_config_roundtrips_and_matches_jax_options():
    from focnerf_tpu.config import parse_options as jparse
    from focnerf_tpu_torch.config import parse_options

    for argv in (["s"], ["s", "-O"], ["s", "-O", "--hyper"], ["s", "--basis", "--bound", "1.5"]):
        jc, tc = jparse(argv, dnerf=True).dnerf_config(), parse_options(argv).dnerf_config()
        d = interop.config_to_dict(tc)
        assert d["__class__"] == "DNeRFConfig" and interop.config_from_dict(d) == tc
        jd = {k: v for k, v in vars(jc).items()}
        jd["compute_dtype"] = "bfloat16" if "bfloat16" in str(jc.compute_dtype) else "float32"
        d.pop("__class__")
        assert d == jd
    jcfg, tcfg = configs("hyper")
    shapes = jax.tree.map(np.shape, jdn.init_dnerf_params(jax.random.key(0), jcfg))
    tp = tdn.init_dnerf_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert {k: [tuple(w.shape) for w in v] if isinstance(v, list) else tuple(v.shape) for k, v in tp.items()} \
        == {k: [tuple(s) for s in v] if isinstance(v, list) else tuple(v) for k, v in shapes.items()}
    assert tcfg.field_spec.input_dim == 5
