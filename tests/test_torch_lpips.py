"""The npz LPIPS (train/lpips_npz.py) on the CPU, held against the JAX
package's (train/lpips_jax.py) on a random-weight npz of the exact
torchvision/lpips shapes (no pretrained weights ship with the repo): the
loader's absent and invalid files, the metric's sanity, the meter taking
over as ``LPIPS (alex, torch)``, and the distance against JAX's."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_lpips_jax import _fake_weights  # noqa: E402

from focnerf_tpu.train import lpips_jax  # noqa: E402
from focnerf_tpu_torch.train import lpips_npz  # noqa: E402
from focnerf_tpu_torch.train.meters import LPIPSMeter  # noqa: E402


@pytest.fixture
def weights(tmp_path):
    p = str(tmp_path / "lpips_alex.npz")
    _fake_weights(p)
    return p


def test_loader_absent_and_invalid(tmp_path, monkeypatch):
    assert lpips_npz.load_weights(str(tmp_path / "nope.npz")) is None
    bad = tmp_path / "bad.npz"
    np.savez(bad, conv0_w=np.zeros((3, 3), np.float32))
    assert lpips_npz.load_weights(str(bad)) is None  # keys missing
    shape = tmp_path / "shape.npz"
    np.savez(shape, **{k: np.zeros((2, 2), np.float32) for k in lpips_npz._CONV_KEYS + lpips_npz._LIN_KEYS})
    assert lpips_npz.load_weights(str(shape)) is None  # conv0 of the wrong shape
    junk = tmp_path / "junk.npz"
    junk.write_bytes(b"not a zip file")
    assert lpips_npz.load_weights(str(junk)) is None
    monkeypatch.setenv("FOCNERF_LPIPS_NPZ", str(shape))
    monkeypatch.setenv("HOME", str(tmp_path))
    assert lpips_npz.default_weight_paths() == [str(shape), os.path.join(str(tmp_path), ".cache/focnerf/lpips_alex.npz")]
    assert lpips_npz.try_create() is None


def test_metric_sanity(weights):
    model = lpips_npz.try_create(weights)
    assert isinstance(model, lpips_npz.NpzLPIPS)
    rng = np.random.default_rng(1)
    a = rng.uniform(size=(64, 64, 3)).astype(np.float32)
    b = rng.uniform(size=(64, 64, 3)).astype(np.float32)
    assert model(a, a) == pytest.approx(0.0, abs=1e-6)
    dab = model(a, b)
    assert dab > 0
    assert model(b, a) == pytest.approx(dab, rel=1e-5)
    # a small perturbation is perceptually closer than an unrelated image
    eps = np.clip(a + 0.01 * rng.normal(size=a.shape).astype(np.float32), 0, 1)
    assert model(a, eps) < dab
    assert model(torch.from_numpy(a), torch.from_numpy(b)) == dab  # tensors where they lie


@pytest.mark.parametrize("hw", [(64, 64), (45, 70)])
def test_distance_matches_jax(weights, hw):
    rng = np.random.default_rng(3)
    a = rng.uniform(size=hw + (3,)).astype(np.float32)
    b = np.clip(a + 0.2 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    jw = lpips_jax.load_weights(weights)
    tw = lpips_npz.load_weights(weights)
    want = float(lpips_jax.lpips_distance(jw, jnp.asarray(a), jnp.asarray(b)))
    got = float(lpips_npz.lpips_distance(tw, torch.from_numpy(a), torch.from_numpy(b)))
    assert want > 0
    # fp32 convolutions summed in another order
    assert got == pytest.approx(want, rel=1e-5)


def test_meter_takeover(weights, tmp_path, monkeypatch):
    monkeypatch.setenv("FOCNERF_LPIPS_NPZ", weights)
    m = LPIPSMeter()
    assert m.available and m.name == "LPIPS (alex, torch)"
    rng = np.random.default_rng(2)
    a = rng.uniform(size=(32, 32, 3)).astype(np.float32)
    b = rng.uniform(size=(32, 32, 3)).astype(np.float32)
    m.update(a, a)
    assert m.measure() == pytest.approx(0.0, abs=1e-6)
    m.clear()
    m.update(torch.from_numpy(a), b)
    assert m.measure() == pytest.approx(lpips_jax.try_create(weights)(a, b), rel=1e-5)
    assert m.report().startswith("LPIPS (alex, torch) = ")

    # without the env var (and no cache file) the labelled substitute stays
    monkeypatch.delenv("FOCNERF_LPIPS_NPZ")
    monkeypatch.setenv("HOME", str(tmp_path))
    m2 = LPIPSMeter()
    assert m2.name in ("LPIPS* (ms-ssim-dist)", "LPIPS (alex)")
