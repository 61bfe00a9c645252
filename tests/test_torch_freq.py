"""The frequency encoding (ops/freq.py) held against the JAX package's on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focnerf_tpu.ops import freq as jfreq
from focnerf_tpu_torch.ops import freq as tfreq


@pytest.mark.parametrize("dim,degree", [(3, 10), (1, 6), (2, 0)])
def test_freq_encode_matches_jax(dim, degree):
    rng = np.random.default_rng(degree)
    x = rng.uniform(-2, 2, (7, 5, dim)).astype(np.float32)
    want = np.asarray(jfreq.freq_encode(jnp.asarray(x), degree))
    got = tfreq.freq_encode(torch.from_numpy(x), degree).numpy()
    assert got.shape == want.shape == (7, 5, tfreq.freq_output_dim(dim, degree))
    assert tfreq.freq_output_dim(dim, degree) == jfreq.freq_output_dim(dim, degree)
    # fp32 sin/cos of the same arguments (x * 2^f is exact): libm against XLA
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
