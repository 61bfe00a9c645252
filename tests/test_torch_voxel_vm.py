"""The VM-factorized family (train/voxel_vm.py) on the CPU against the JAX
package's: the collapse, the regularizers, the upsample, one loss and
gradient and 5 Adam steps from shared factors, and the npz across
packages."""

import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_voxel import check_family  # noqa: E402

from focnerf_tpu.train import voxel_vm as jvm  # noqa: E402
from focnerf_tpu_torch import interop  # noqa: E402
from focnerf_tpu_torch.train import voxel_vm as tvm  # noqa: E402


def jax_field(R=16, rank=4, seed=0):
    return jvm.init_vm_field(R, rank=rank, rng=jax.random.key(seed), init_scale=0.3)


def test_collapse_and_regularizers_match_jax():
    jf = jax_field(8)
    tf = interop.vm_field_from_jax(jf)
    np.testing.assert_allclose(tvm.collapse_vm(tf).numpy(), np.asarray(jvm.collapse_vm(jf)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tvm.vm_field_to_volume(tf, 1.0).rgba.numpy(),
                               np.asarray(jvm.vm_field_to_volume(jf, 1.0).rgba), rtol=1e-5, atol=1e-6)
    for l1 in (0.0, 1e-3):
        np.testing.assert_allclose(float(tvm.vm_reg(tf, 1e-2, l1)), float(jvm.vm_reg(jf, 1e-2, l1)), rtol=1e-5)


@pytest.mark.parametrize("src,dst", [(4, 8), (5, 9)])
def test_upsample_vm_matches_jax(src, dst):
    jf = jax_field(src, rank=2, seed=src)
    got = tvm.upsample_vm(interop.vm_field_from_jax(jf), dst)
    want = jvm.upsample_vm(jf, dst)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=2e-6)


def test_loss_gradient_and_adam_steps_match_jax():
    check_family(lambda f, t: jvm.collapse_vm(f), lambda f: jvm.vm_reg(f, 1e-4, 1e-4),
                 lambda f, t: tvm.collapse_vm(f), lambda f: tvm.vm_reg(f, 1e-4, 1e-4),
                 jax_field(), np.zeros(8, np.float32), lr=2e-2)


def test_npz_across_packages(tmp_path):
    """Each package loads the other's file to the same collapsed volume."""
    jf = jax_field(8)
    tf = interop.vm_field_from_jax(jf)
    jvm.save_vm_field(str(tmp_path / "j.npz"), jf, 1.5, 0)
    tvm.save_vm_field(str(tmp_path / "t.npz"), tf, 1.5, 0)
    for src in ("j", "t"):
        jl, jb_, js = jvm.load_vm_field(str(tmp_path / f"{src}.npz"))
        tl, tb_, ts = tvm.load_vm_field(str(tmp_path / f"{src}.npz"), device="cpu")
        assert jb_ == tb_ == 1.5 and js == ts == 0
        np.testing.assert_allclose(tvm.collapse_vm(tl).numpy(), np.asarray(jvm.collapse_vm(jl)), rtol=1e-5,
                                   atol=1e-6)
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])

