"""ops/encoding.py::get_encoder against the JAX package's on the CPU: each
name's output dimension, and its features on the same inputs (the hash
grid from the same table); an unknown name raises."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focnerf_tpu.ops.encoding import get_encoder as jget
from focnerf_tpu_torch.ops.encoding import get_encoder as tget

CASES = [
    ("None", dict(input_dim=3)),
    ("frequency", dict(input_dim=2, degree=3)),
    ("frequency", dict(input_dim=3, degree=6)),
    ("sphere_harmonics", dict(degree=4)),
    ("sphere_harmonics", dict(degree=2)),
    ("hashgrid", dict(num_levels=4, base_resolution=4, log2_hashmap_size=8, desired_resolution=64)),
    ("tiledgrid", dict(num_levels=2, level_dim=4, base_resolution=8, log2_hashmap_size=11)),
]


@pytest.mark.parametrize("name,kw", CASES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_get_encoder_matches_jax(name, kw):
    jfn, jinit, jdim = jget(name, **kw)
    tfn, tinit, tdim = tget(name, **kw)
    assert tdim == jdim
    D = kw.get("input_dim", 3)
    x = np.random.default_rng(0).uniform(0, 1, (64, D)).astype(np.float32)
    if name == "sphere_harmonics":
        x = x * 2 - 1
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
    jparams = jinit(jax.random.key(0))
    if jparams is None:
        assert tinit(torch.Generator().manual_seed(0)) is None
        tparams = None
    else:  # the same table on both sides, wide enough that the features differ
        table = np.random.default_rng(1).uniform(-1, 1, np.asarray(jparams).shape).astype(np.float32)
        jparams, tparams = jnp.asarray(table), torch.from_numpy(table)
        assert tuple(tinit(torch.Generator().manual_seed(0)).shape) == table.shape
    want = np.asarray(jfn(jparams, jnp.asarray(x)))
    got = tfn(tparams, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (64, tdim)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_unknown_encoding_raises():
    with pytest.raises(ValueError, match="bogus"):
        tget("bogus")
