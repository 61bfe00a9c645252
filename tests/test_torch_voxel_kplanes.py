"""The K-planes family (train/voxel_kplanes.py) on the CPU against the JAX
package's: the time vectors, the collapse at several t, the regularizers,
the upsample, one loss and gradient per view time and 5 Adam steps from
shared planes, and the npz across packages."""

import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_voxel import check_family  # noqa: E402
from test_torch_voxel_dynamic import TIMES  # noqa: E402

from focnerf_tpu.train import voxel_kplanes as jkp  # noqa: E402
from focnerf_tpu_torch import interop  # noqa: E402
from focnerf_tpu_torch.train import voxel_kplanes as tkp  # noqa: E402


def jax_field(R=16, rank=3, T=5, seed=0):
    return jkp.init_kplanes_field(R, rank=rank, time_res=T, rng=jax.random.key(seed), init_scale=0.3, w0=0.5)


@pytest.mark.parametrize("t", [0.0, 0.3, 0.5, 1.0, 1.3])
def test_time_vectors_and_collapse_match_jax(t):
    jf = jax_field(6)
    tf = interop.kplanes_field_from_jax(jf)
    np.testing.assert_allclose(tkp._time_vectors(tf.time, t).numpy(), np.asarray(jkp._time_vectors(jf.time, t)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tkp.collapse_kplanes(tf, t).numpy(), np.asarray(jkp.collapse_kplanes(jf, t)),
                               rtol=1e-5, atol=1e-6)


def test_regularizers_match_jax():
    jf = jax_field(6)
    tf = interop.kplanes_field_from_jax(jf)
    np.testing.assert_allclose(float(tkp.kplanes_tv_loss(tf)), float(jkp.kplanes_tv_loss(jf)), rtol=1e-5)
    np.testing.assert_allclose(float(tkp.kplanes_time_smoothness(tf)), float(jkp.kplanes_time_smoothness(jf)),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tkp.kplanes_reg(tf, 1e-2, 1e-1)), float(jkp.kplanes_reg(jf, 1e-2, 1e-1)),
                               rtol=1e-5)


@pytest.mark.parametrize("src,dst", [(4, 8), (5, 9)])
def test_upsample_kplanes_matches_jax(src, dst):
    jf = jax_field(src, rank=2, seed=src)
    got = tkp.upsample_kplanes(interop.kplanes_field_from_jax(jf), dst)
    for g, w in zip(got, jkp.upsample_kplanes(jf, dst)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=2e-6)


def test_loss_gradient_and_adam_steps_match_jax():
    check_family(jkp.collapse_kplanes, lambda f: jkp.kplanes_reg(f, 1e-4, 1e-3),
                 tkp.collapse_kplanes, lambda f: tkp.kplanes_reg(f, 1e-4, 1e-3),
                 jax_field(), TIMES, lr=2e-2)


def test_npz_across_packages(tmp_path):
    jf = jax_field(6)
    jkp.save_kplanes_field(str(tmp_path / "j.npz"), jf, 1.0, 0)
    tkp.save_kplanes_field(str(tmp_path / "t.npz"), interop.kplanes_field_from_jax(jf), 1.0, 0)
    for src in ("j", "t"):
        jl, _, _ = jkp.load_kplanes_field(str(tmp_path / f"{src}.npz"))
        tl, bound, sh = tkp.load_kplanes_field(str(tmp_path / f"{src}.npz"), device="cpu")
        assert (bound, sh) == (1.0, 0)
        for t in (0.0, 0.6):
            np.testing.assert_allclose(tkp.kplanes_field_to_volume(tl, t, 1.0).rgba.numpy(),
                                       np.asarray(jkp.kplanes_field_to_volume(jl, t, 1.0).rgba), rtol=1e-5,
                                       atol=1e-6)
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])

