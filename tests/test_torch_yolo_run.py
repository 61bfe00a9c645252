"""The YOLO run of the sidecar on the CPU, against the JAX package:
``run_yolo_on_frames`` on tests/test_yolo_fake.py's fake ultralytics with
cv2, PIL and imageio unimportable for the port (masks and boxes exact,
features within 1e-6), ``preprocess_scene``'s three branches (disable_yolo,
ultralytics present, ultralytics missing) writing JAX's sidecars, and the
port's cv2 stand-ins (``imread_bgr``, ``resize_linear_u8``,
``resize_nearest``) bit for bit against cv2 itself.
"""

import json
import os
import sys
import types

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_yolo_fake import H, W, _install_fake_ultralytics, _make_results  # noqa: E402

from focnerf_tpu.data import yolo_sidecar as jyolo  # noqa: E402
from focnerf_tpu_torch.data import yolo_sidecar as tyolo  # noqa: E402

BLOCKED = ("cv2", "PIL", "imageio", "imageio.v2")


def _block_image_libraries(monkeypatch):
    for name in BLOCKED:
        monkeypatch.setitem(sys.modules, name, None)  # an import raises ImportError


def _write_frames(root):
    """Three 64x64 frames in the formats cv2.imread converts: 8-bit RGB,
    8-bit RGBA (alpha dropped) and 16-bit RGB (shifted to 8 bits)."""
    rng = np.random.default_rng(0)
    paths = [os.path.join(root, f"r_{v}.png") for v in range(3)]
    imageio.imwrite(paths[0], (rng.random((H, W, 3)) * 255).astype(np.uint8))
    imageio.imwrite(paths[1], (rng.random((H, W, 4)) * 255).astype(np.uint8))
    cv2.imwrite(paths[2], (rng.random((H, W, 3)) * 65535).astype(np.uint16))
    return paths


def _assert_same_sidecar(got, want):
    assert list(got["names"]) == list(want["names"])
    assert sorted(got) == sorted(want)
    for key in want:
        if key.endswith("__feats"):
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6, err_msg=key)
        elif key != "names":
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
            assert got[key].dtype == want[key].dtype, key


def test_run_yolo_on_frames_matches_jax(tmp_path, monkeypatch):
    paths = _write_frames(str(tmp_path))
    _install_fake_ultralytics(monkeypatch, _make_results())
    want = jyolo.run_yolo_on_frames(paths, "fake.pt")
    _install_fake_ultralytics(monkeypatch, _make_results())
    _block_image_libraries(monkeypatch)
    got = tyolo.run_yolo_on_frames(paths, "fake.pt")
    assert want["names"] == ["book", "cup", "background"]
    assert want["cup__masks"][0].any() and not want["background__masks"][0].all()  # the fake detected
    _assert_same_sidecar(got, want)


class _BackboneOnMeta(torch.nn.Module):
    """A backbone whose parameters ultralytics has moved away from the CPU
    (``meta`` stands for the card here) and to fp64: its input must follow
    them."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(1, device="meta", dtype=torch.float64))
        self.seen = []

    def forward(self, x):
        self.seen.append((x.device.type, x.dtype, tuple(x.shape)))
        return (None, [[None, None, torch.ones(1, 144, 20, 20, dtype=torch.float64)]])


def test_backbone_input_follows_the_model_device(tmp_path, monkeypatch):
    paths = _write_frames(str(tmp_path))
    backbone = _BackboneOnMeta()
    results = iter(_make_results())

    class _YOLO:
        def __init__(self, model_name):
            self.model = backbone

        def predict(self, img, conf=0.25, verbose=False):
            return [next(results)]

    mod = types.ModuleType("ultralytics")
    mod.YOLO = _YOLO
    monkeypatch.setitem(sys.modules, "ultralytics", mod)
    _block_image_libraries(monkeypatch)
    got = tyolo.run_yolo_on_frames(paths, "fake.pt")
    assert backbone.seen == [("meta", torch.float64, (1, 3, 640, 640))] * len(paths)
    assert got["background__feats"].dtype == np.float32
    np.testing.assert_array_equal(got["background__feats"], np.ones((len(paths), 144), np.float32))


def _scene(root):
    os.makedirs(root)
    paths = _write_frames(root)
    frames = [{"file_path": os.path.basename(p), "transform_matrix": np.eye(4).tolist()} for p in paths]
    with open(os.path.join(root, "transforms_train.json"), "w") as fh:
        json.dump({"camera_angle_x": 0.7, "frames": frames}, fh)
    return root


@pytest.mark.parametrize("branch", ["disable_yolo", "ultralytics", "no ultralytics"])
def test_preprocess_scene_takes_jax_branch(tmp_path, monkeypatch, capsys, branch):
    """Each package preprocesses its own copy of the scene; the sidecars are
    equal. Only the port's missing-ultralytics branch says so, in one line."""
    jscene, tscene = _scene(str(tmp_path / "j")), _scene(str(tmp_path / "t"))
    kw = dict(splits=("train",), model_name="fake.pt", disable_yolo=branch == "disable_yolo")
    if branch == "no ultralytics":
        monkeypatch.setitem(sys.modules, "ultralytics", None)
    else:
        _install_fake_ultralytics(monkeypatch, _make_results())
    jyolo.preprocess_scene(jscene, **kw)
    if branch == "ultralytics":
        _install_fake_ultralytics(monkeypatch, _make_results())
    capsys.readouterr()
    _block_image_libraries(monkeypatch)
    tyolo.preprocess_scene(tscene, **kw)
    said = capsys.readouterr().out
    assert said.count("ultralytics is not installed") == (branch == "no ultralytics")
    want, got = jyolo.load_sidecar(jscene, "train"), tyolo.load_sidecar(tscene, "train")
    assert (list(want["names"]) == ["background"]) == (branch != "ultralytics")
    _assert_same_sidecar(got, want)


# (h, w) -> (W, H): the backbone's 640 input from several frame sizes, the
# 20 x 20 mask from a 2x shrink (INTER_AREA), a 3.2x, a 40x and a ragged
# one, 2x upsamples, tiny sources
RESIZES = [((64, 64), (640, 640)), ((800, 800), (640, 640)), ((480, 640), (640, 640)), ((7, 9), (640, 640)),
           ((40, 40), (20, 20)), ((64, 64), (20, 20)), ((800, 800), (20, 20)), ((37, 53), (20, 20)),
           ((32, 32), (64, 64)), ((13, 17), (39, 51)), ((1, 1), (20, 20)), ((800, 800), (400, 400))]


def test_resizes_match_cv2_bit_for_bit():
    rng = np.random.default_rng(1)
    for (h, w), (dw, dh) in RESIZES:
        for shape in ((h, w), (h, w, 3)):
            for img in ((rng.random(shape) * 256).astype(np.uint8), (rng.random(shape) > 0.5).astype(np.uint8)):
                np.testing.assert_array_equal(tyolo.resize_linear_u8(img, dw, dh), cv2.resize(img, (dw, dh)),
                                              err_msg=f"{shape} -> {(dh, dw)}")
    for (h, w), (dw, dh) in [((32, 32), (64, 64)), ((32, 32), (800, 800)), ((30, 47), (80, 64)), ((64, 64), (32, 32))]:
        m = (rng.random((h, w)) > 0.5).astype(np.uint8)
        np.testing.assert_array_equal(tyolo.resize_nearest(m, dw, dh),
                                      cv2.resize(m, (dw, dh), interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("with_imageio", [True, False])
def test_imread_bgr_matches_cv2(tmp_path, monkeypatch, with_imageio):
    """gray, gray + alpha, RGB, RGBA at 8 bits and RGB, RGBA at 16: read
    through imageio where it imports, else through data/png.py."""
    rng = np.random.default_rng(2)
    files = {}
    for name, shape in (("g", (5, 7)), ("ga", (5, 7, 2)), ("rgb", (5, 7, 3)), ("rgba", (5, 7, 4))):
        files[name] = str(tmp_path / f"{name}.png")
        imageio.imwrite(files[name], (rng.random(shape) * 256).astype(np.uint8))
    for name, shape in (("rgb16", (5, 7, 3)), ("rgba16", (5, 7, 4))):
        files[name] = str(tmp_path / f"{name}.png")
        cv2.imwrite(files[name], (rng.random(shape) * 65536).astype(np.uint16))
    want = {name: cv2.imread(path) for name, path in files.items()}
    if not with_imageio:
        _block_image_libraries(monkeypatch)
    for name, path in files.items():
        got = tyolo.imread_bgr(path)
        assert got.dtype == np.uint8 and got.flags.c_contiguous
        np.testing.assert_array_equal(got, want[name], err_msg=name)
