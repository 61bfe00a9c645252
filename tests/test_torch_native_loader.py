"""The native threaded batch loader (data/native_loader.py over
native/dataloader.cpp) and the provider's host pipeline (``--no-preload``)
on the CPU, held against the JAX package's:

  - the loader's pixels come from its images, every view is drawn, and with
    one worker thread and one seed the port's loader and JAX's yield the
    same (view, indices, pixels) sequence (the same C++ source);
  - the library is built into focnerf_tpu_torch/build/, never into native/;
  - the host pipeline's uint8 stack and its batches equal JAX's (one worker
    on both sides), its eval views carry the GT, it refuses the error map,
    and an unbuildable library falls back to preloading with JAX's line;
  - ``main_nerf --no-preload --cuda_ray`` trains from host batches.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from helpers import make_synthetic_scene  # noqa: E402
from test_torch_model import start_torch_threads  # noqa: E402,F401  (starts torch's pool first)

from focnerf_tpu.data import native_loader as jnl  # noqa: E402
from focnerf_tpu.data.provider import DatasetOptions as JDatasetOptions  # noqa: E402
from focnerf_tpu.data.provider import NeRFDataset as JNeRFDataset  # noqa: E402
from focnerf_tpu_torch.data import native_loader as tnl  # noqa: E402
from focnerf_tpu_torch.data.provider import DatasetOptions, NeRFDataset  # noqa: E402
from focnerf_tpu_torch.utils import mesh_extract  # noqa: E402
from focnerf_tpu_torch.utils.mesh_extract import BUILD_DIR  # noqa: E402


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_synthetic_scene(str(tmp_path_factory.mktemp("loader") / "scene"), n_train=3, n_val=1)


def test_library_builds_into_the_build_dir():
    before = sorted(os.listdir(os.path.dirname(tnl.SOURCE)))
    assert tnl.available(), tnl.library_note()
    path = tnl.library_note()
    assert os.path.dirname(path) == BUILD_DIR and os.path.basename(path).startswith("libdataloader_")
    assert path.endswith(".so") and os.path.exists(path)
    assert sorted(os.listdir(os.path.dirname(tnl.SOURCE))) == before  # nothing written into native/


def test_loader_pixels_match_source():
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, size=(3, 64, 4), dtype=np.uint8)
    with tnl.NativeBatchLoader(images, batch_rays=16, seed=7) as ld:
        for _ in range(8):
            view, inds, pix = ld.next()
            assert 0 <= view < 3
            assert inds.shape == (16,) and ((inds >= 0) & (inds < 64)).all()
            np.testing.assert_allclose(pix, images[view][inds].astype(np.float32) / 255.0, atol=1e-6)
    with pytest.raises(RuntimeError, match="closed"):
        ld.next()
    with pytest.raises(ValueError, match="uint8"):
        tnl.NativeBatchLoader(images.astype(np.float32), batch_rays=4)


def test_loader_covers_views_and_pixels():
    images = np.zeros((4, 32, 1), np.uint8)
    seen_views = set()
    with tnl.NativeBatchLoader(images, batch_rays=8, n_threads=3) as ld:
        for _ in range(32):
            v, _, _ = ld.next()
            seen_views.add(v)
    assert len(seen_views) == 4  # every view gets drawn


@pytest.mark.parametrize("seed", [0, 1234])
def test_loader_matches_jax_with_one_worker(seed):
    assert jnl.available()
    images = np.random.default_rng(seed).integers(0, 256, size=(5, 96, 3), dtype=np.uint8)
    with tnl.NativeBatchLoader(images, 32, n_threads=1, seed=seed) as t, \
            jnl.NativeBatchLoader(images, 32, n_threads=1, seed=seed) as j:
        for _ in range(12):
            (tv, ti, tp), (jv, ji, jp) = t.next(), j.next()
            assert tv == jv
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tp, jp)


@pytest.fixture
def one_worker(monkeypatch):
    """Both packages' host pipelines with one loader thread: one sequence."""
    for mod in (tnl, jnl):
        real = mod.NativeBatchLoader

        class OneWorker(real):
            def __init__(self, images, batch_rays, **kw):
                super().__init__(images, batch_rays, **dict(kw, n_threads=1))

        monkeypatch.setattr(mod, "NativeBatchLoader", OneWorker)


def test_host_pipeline_matches_jax(scene, one_worker):
    from focnerf_tpu_torch.data.yolo_sidecar import load_sidecar, preprocess_scene
    from focnerf_tpu_torch.apps.main_nerf import mask_details_for

    preprocess_scene(scene, disable_yolo=True)
    details = mask_details_for(load_sidecar(scene, "train"), "background")
    t = NeRFDataset(DatasetOptions(path=scene, scale=1.0, num_rays=32, host_pipeline=True), split="train",
                    mask_details=details, device="cpu")
    j = JNeRFDataset(JDatasetOptions(path=scene, scale=1.0, num_rays=32, host_pipeline=True), split="train",
                     mask_details=details)
    try:
        assert t.images is None and t.images_host.dtype == np.uint8 and t.images_host.flags.c_contiguous
        np.testing.assert_array_equal(t.images_host, j.images_host)
        for _ in range(4):
            tb, jb = t.train_batch(None), j.train_batch(None)
            assert int(tb["view"]) == int(jb["view"])
            np.testing.assert_array_equal(tb["pixels"].numpy(), np.asarray(jb["pixels"]))
            np.testing.assert_array_equal(tb["ray_mask"].numpy(), np.asarray(jb["ray_mask"]))
            np.testing.assert_array_equal(tb["obj_feat"].numpy(), np.asarray(jb["obj_feat"]))
            for k in ("rays_o", "rays_d"):
                np.testing.assert_allclose(tb[k].numpy(), np.asarray(jb[k]), atol=1e-6)
            assert tb["pixels"].dtype == torch.float32 and tb["pixels"].shape == (32, 4)
        ev = t.eval_view(1)
        np.testing.assert_array_equal(ev["pixels"].numpy(), np.asarray(j.eval_view(1)["pixels"]))
        with pytest.raises(ValueError, match="draws=None"):
            t.train_batch(None, draws={"view": torch.zeros(1, dtype=torch.int64)})
    finally:
        t.close()
        j._native_loader.close()
    val = NeRFDataset(DatasetOptions(path=scene, scale=1.0, host_pipeline=True), split="val", device="cpu")
    assert val.images is not None and val.images_host is None  # only the train split stays on the host


def test_host_pipeline_refuses_error_map_and_falls_back_without_the_library(scene, monkeypatch, capsys):
    with pytest.raises(ValueError, match="samples uniformly"):
        NeRFDataset(DatasetOptions(path=scene, scale=1.0, host_pipeline=True, error_map=True), split="train",
                    device="cpu")
    monkeypatch.setitem(mesh_extract._native, "dataloader", (None, "no C++ compiler"))
    ds = NeRFDataset(DatasetOptions(path=scene, scale=1.0, host_pipeline=True), split="train", device="cpu")
    assert "[WARN] native loader unavailable; preloading to device" in capsys.readouterr().out
    assert ds.images is not None and ds.images_host is None
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        tnl.NativeBatchLoader(np.zeros((1, 4, 3), np.uint8), 2)


def test_main_nerf_no_preload_trains_from_host_batches(scene, tmp_path, monkeypatch):
    from focnerf_tpu_torch.apps import main_nerf
    from focnerf_tpu_torch.config import parse_options

    assert parse_options([scene, "--no-preload"]).dataset_options().host_pipeline
    assert not parse_options([scene, "-O", "--no-preload"]).dataset_options().host_pipeline  # -O preloads
    drawn, closed = [], []
    real_batch, real_close = NeRFDataset._host_train_batch, NeRFDataset.close
    monkeypatch.setattr(NeRFDataset, "_host_train_batch", lambda self: drawn.append(1) or real_batch(self))
    monkeypatch.setattr(NeRFDataset, "close", lambda self: closed.append(self._native_loader) or real_close(self))
    (tr,) = main_nerf.main([scene, "--workspace", str(tmp_path / "ws"), "--no-preload", "--cuda_ray", "--scale",
                            "1.0", "--bound", "1.0", "--grid_levels", "4", "--num_rays", "64", "--iters", "3",
                            "--disable_yolo", "--mesh_res", "0", "--no-eval_save_images"], device="cpu")
    assert tr.global_step == 3 and len(drawn) == 3
    assert np.isfinite(tr.step_losses).all() and np.isfinite(tr.last_eval_results["PSNR"])
    assert closed and closed[0] is not None  # the loader's threads were stopped after training
