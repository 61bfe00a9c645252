"""The low-rank dynamic family (train/voxel_dynamic.py) on the CPU against
the JAX package's: time weights, the collapse at several t, the
regularizer, one loss and gradient per view time and 5 Adam steps from
shared parameters, and the npz across packages."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_voxel import check_family  # noqa: E402

from focnerf_tpu.train import voxel_dynamic as jdyn  # noqa: E402
from focnerf_tpu_torch import interop  # noqa: E402
from focnerf_tpu_torch.train import voxel_dynamic as tdyn  # noqa: E402

TIMES = np.array([0.0, 0.13, 0.5, 1.0, 0.7, 0.999, 0.25, 0.42], np.float32)


def jax_field(R=16, rank=3, slots=5, seed=0):
    """The JAX init with non-zero deltas and uneven slot weights."""
    f = jdyn.init_dyn_voxel_field(R, rank=rank, time_slots=slots, rng=jax.random.key(seed))
    k1, k2 = jax.random.split(jax.random.key(seed + 1))
    return f._replace(deltas=0.3 * jax.random.normal(k1, f.deltas.shape),
                      wslots=jax.random.uniform(k2, f.wslots.shape, minval=-1.0, maxval=1.0))


@pytest.mark.parametrize("t", [0.0, 0.13, 0.5, 0.999, 1.0, -0.2, 1.4])
def test_time_weights_and_collapse_match_jax(t):
    jf = jax_field(6)
    tf = interop.dyn_field_from_jax(jf)
    np.testing.assert_allclose(tdyn.time_weights(tf.wslots, t).numpy(),
                               np.asarray(jdyn.time_weights(jf.wslots, t)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tdyn.collapse_field(tf, t).numpy(), np.asarray(jdyn.collapse_field(jf, t)),
                               rtol=1e-5, atol=1e-6)


def test_regularizer_matches_jax():
    jf = jax_field(6)
    np.testing.assert_allclose(float(tdyn.dyn_reg(interop.dyn_field_from_jax(jf), 1e-2, 1e-1)),
                               float(jdyn.dyn_reg(jf, 1e-2, 1e-1)), rtol=1e-5)


def test_loss_gradient_and_adam_steps_match_jax():
    check_family(jdyn.collapse_field, lambda f: jdyn.dyn_reg(f, 1e-4, 1e-3),
                 tdyn.collapse_field, lambda f: tdyn.dyn_reg(f, 1e-4, 1e-3),
                 jax_field(), TIMES, lr=5e-2)


def test_npz_across_packages(tmp_path):
    jf = jax_field(6)
    jdyn.save_dyn_field(str(tmp_path / "j.npz"), jf, 1.0, 0)
    tdyn.save_dyn_field(str(tmp_path / "t.npz"), interop.dyn_field_from_jax(jf), 1.0, 0)
    for src in ("j", "t"):
        jl, _, _ = jdyn.load_dyn_field(str(tmp_path / f"{src}.npz"))
        tl, bound, sh = tdyn.load_dyn_field(str(tmp_path / f"{src}.npz"), device="cpu")
        assert (bound, sh) == (1.0, 0)
        for t in (0.0, 0.6):
            np.testing.assert_allclose(tdyn.dyn_field_to_volume(tl, t, 1.0).rgba.numpy(),
                                       np.asarray(jdyn.dyn_field_to_volume(jl, t, 1.0).rgba), rtol=1e-5, atol=1e-6)
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    assert jnp.asarray(jl.deltas).dtype == jnp.float32
