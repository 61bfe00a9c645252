"""train/loss.py against the JAX package's on the CPU: MAPE and Huber
(mean and per element), and the distortion loss with its gradients, which
autograd takes through the prefix sums (JAX differentiates the same form)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focnerf_tpu.train import loss as jloss
from focnerf_tpu_torch.train import loss as tloss


def _pair(seed=0, shape=(8, 16)):
    rng = np.random.default_rng(seed)
    pred = rng.normal(size=shape).astype(np.float32)
    target = rng.normal(size=shape).astype(np.float32)
    target[0, :3] = 0.0  # |gt| + eps at its smallest
    return pred, target


@pytest.mark.parametrize("name,kw", [("mape_loss", dict(eps=1e-2)), ("mape_loss", dict(eps=0.0)),
                                     ("huber_loss", dict(delta=0.1)), ("huber_loss", dict(delta=2.0))])
@pytest.mark.parametrize("reduction", ["mean", "none"])
def test_pointwise_losses_match_jax(name, kw, reduction):
    pred, target = _pair()
    if kw.get("eps") == 0.0:
        target[0, :3] = 1.0  # no division by zero
    want = np.asarray(getattr(jloss, name)(jnp.asarray(pred), jnp.asarray(target), reduction=reduction, **kw))
    got = getattr(tloss, name)(torch.from_numpy(pred), torch.from_numpy(target), reduction=reduction, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_eff_distloss_and_its_gradients_match_jax():
    rng = np.random.default_rng(3)
    w = rng.uniform(0, 0.2, (2, 4, 32)).astype(np.float32)
    m = np.sort(rng.uniform(0, 1, (2, 4, 32)), axis=-1).astype(np.float32)
    d = rng.uniform(0.01, 0.05, (2, 4, 32)).astype(np.float32)
    want, jgrads = jax.value_and_grad(jloss.eff_distloss, argnums=(0, 1, 2))(*map(jnp.asarray, (w, m, d)))
    args = [torch.from_numpy(a).requires_grad_() for a in (w, m, d)]
    got = tloss.eff_distloss(*args)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    for a, g in zip(args, jgrads):  # prefix sums of 32 fp32 terms, in the same order
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), rtol=1e-5, atol=1e-7)
    # all weight on one sample: no pairwise spread, the self term only
    one = torch.zeros(1, 8)
    one[0, 3] = 1.0
    val = tloss.eff_distloss(one, torch.linspace(0, 1, 8)[None], torch.full((1, 8), 0.125))
    assert float(val) == pytest.approx(0.125 / 3, rel=1e-6)
