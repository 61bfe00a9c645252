"""YOLOv8-seg preprocessing sidecar: ``<scene>/yolo/<split>.npz``.

Twin of focnerf_tpu/data/yolo_sidecar.py (same file format, so either
package reads what the other wrote):

  names: [str] detected object class names (+ "background");
  paths: [V] image paths relative to the scene root;
  per object <obj>: ``<obj>__masks`` [V, H, W] bool, ``<obj>__feats``
  [V, F] f32, ``<obj>__bboxes`` [V, 4] f32.

``preprocess_scene`` takes JAX's branches: with ``ultralytics`` importable
and without ``disable_yolo`` it runs YOLOv8-seg (``run_yolo_on_frames``,
the reference's get_object_masks, utils.py:364-477), else the sidecar
holds one full-image "background" object (the disable_yolo mode). Per
frame, every instance of a class is OR-merged into the class's mask (its
box is the last instance's), the background is the complement of the
union, and each object's feature is the mean of the backbone's [144, 20,
20] map over its mask resized to 20 x 20 (zeros when that is empty).

JAX gets its pixels from cv2, which the port does not import (nor PIL or
imageio): ``imread_bgr`` reads as ``cv2.imread`` does (BGR uint8, alpha
dropped, gray repeated, 16 bits shifted to 8), ``resize_linear_u8`` is
``cv2.resize``'s INTER_LINEAR on uint8 (11-bit fixed-point weights, its
rounding, INTER_AREA for an exact 2x shrink) and ``resize_nearest`` its
INTER_NEAREST (source index floor(dst * src / dst)), bit for bit.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from focnerf_tpu_torch.data.png import read_image


def yolo_available() -> bool:
    try:  # pragma: no cover - depends on an optional package
        import ultralytics  # noqa: F401
    except ImportError:
        return False
    return True


def background_only_masks(image_paths: List[str], H: int, W: int) -> Dict:
    """disable_yolo fallback: one 'background' object with the full-image mask."""
    V = len(image_paths)
    return {
        "names": ["background"],
        "background__masks": np.ones((V, H, W), bool),
        "background__feats": np.zeros((V, 144), np.float32),
        "background__bboxes": np.full((V, 4), -1.0, np.float32),
    }


def imread_bgr(path: str) -> np.ndarray:
    """uint8 [H, W, 3] in BGR order, as ``cv2.imread(path)`` gives it."""
    img = read_image(path)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] < 3:  # gray (+ alpha): the gray channel three times
        img = np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., 2::-1])


RESIZE_COEF_SCALE = 2048  # cv2's INTER_RESIZE_COEF_SCALE: 11-bit fixed-point weights


def _linear_taps(src: int, dst: int, clamp: bool):
    """cv2's INTER_LINEAR taps along one axis -> (first source index, second,
    their weights summing to RESIZE_COEF_SCALE). Source position (d + 0.5) *
    src / dst - 0.5 in float32; along x (``clamp``) a position past an edge
    takes the edge pixel with weight 1, along y only the row indices clip."""
    pos = ((np.arange(dst, dtype=np.float64) + 0.5) * (1.0 / (dst / src)) - 0.5).astype(np.float32)
    first = np.floor(pos).astype(np.int64)
    frac = (pos - first.astype(np.float32)).astype(np.float32)
    if clamp:
        out = (first < 0) | (first >= src - 1)
        frac[out] = 0.0
        first = np.where(first < 0, 0, np.where(first >= src - 1, src - 1, first))
    scale = np.float32(RESIZE_COEF_SCALE)
    w0 = np.rint((np.float32(1.0) - frac) * scale).astype(np.int64)
    w1 = np.rint(frac * scale).astype(np.int64)
    return np.clip(first, 0, src - 1), np.clip(first + 1, 0, src - 1), w0, w1


def resize_linear_u8(img: np.ndarray, W: int, H: int) -> np.ndarray:
    """``cv2.resize(img, (W, H))`` (INTER_LINEAR) of uint8 [h, w] or [h, w,
    C], bit for bit: horizontal taps into int rows, then the vertical blend
    ((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4)) >> 16) + 2) >> 2; an exact
    2x shrink is cv2's INTER_AREA, the rounded mean of each 2 x 2 block."""
    h, w = img.shape[:2]
    x = np.asarray(img).astype(np.int64)
    if h == 2 * H and w == 2 * W:
        return ((x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2] + 2) >> 2).astype(np.uint8)
    sx0, sx1, a0, a1 = _linear_taps(w, W, clamp=True)
    sy0, sy1, b0, b1 = _linear_taps(h, H, clamp=False)
    along_x = (slice(None),) + (None,) * (x.ndim - 2)
    rows = x[:, sx0] * a0[along_x] + x[:, sx1] * a1[along_x]  # [h, W, ...]
    along_y = (slice(None),) + (None,) * (x.ndim - 1)
    out = (((b0[along_y] * (rows[sy0] >> 4)) >> 16) + ((b1[along_y] * (rows[sy1] >> 4)) >> 16) + 2) >> 2
    return out.astype(np.uint8)


def resize_nearest(img: np.ndarray, W: int, H: int) -> np.ndarray:
    """``cv2.resize(img, (W, H), interpolation=cv2.INTER_NEAREST)``."""
    h, w = img.shape[:2]
    sx = np.minimum(np.floor(np.arange(W) * (1.0 / (W / w))).astype(np.int64), w - 1)
    sy = np.minimum(np.floor(np.arange(H) * (1.0 / (H / h))).astype(np.int64), h - 1)
    return img[sy][:, sx]


def _to_backbone(torch_model, x):
    """``x`` on the device and in the dtype of the backbone's parameters:
    ``predict`` moves the model where ultralytics runs it (the card), and a
    model without parameters takes ``x`` as it is."""
    params = getattr(torch_model, "parameters", None)
    p = next(params(), None) if params is not None else None
    return x if p is None else x.to(p.device, p.dtype)


def run_yolo_on_frames(
    image_paths: List[str],
    model_name: str = "yolov8s-seg.pt",
    conf: float = 0.25,
    feat_dim: int = 144,
) -> Dict:
    """Run YOLOv8-seg over frames -> the sidecar's arrays (see the module
    docstring). The model and its backbone run where ultralytics puts them
    (the backbone's input follows its parameters); the features come back
    to the host."""
    import torch
    from ultralytics import YOLO

    model = YOLO(model_name)
    torch_model = model.model  # backbone access for features
    images, results, feats_cache = [], [], []
    for path in image_paths:
        img = imread_bgr(path)
        images.append(img)
        results.append(model.predict(img, conf=conf, verbose=False)[0])
        with torch.no_grad():  # penultimate activations [1, 144, 20, 20] (provider.py:282+)
            x = torch.from_numpy(resize_linear_u8(img, 640, 640).astype(np.float32) / 255.0).permute(2, 0, 1)[None]
            feats_cache.append(torch_model(_to_backbone(torch_model, x))[1][0][2][0].float().cpu().numpy())
    H, W = images[0].shape[:2]
    V = len(image_paths)
    names = sorted({res.names[int(c)] for res in results
                    for c in (res.boxes.cls.tolist() if res.boxes is not None else [])})

    per_obj = {obj: {"masks": [], "feats": [], "boxes": []} for obj in names}
    union_masks = []
    for v, res in enumerate(results):
        union = np.zeros((H, W), bool)
        frame_masks = {obj: np.zeros((H, W), bool) for obj in names}
        frame_boxes = {obj: np.full(4, -1.0, np.float32) for obj in names}
        if res.masks is not None:
            for mask, cls, box in zip(res.masks.data, res.boxes.cls, res.boxes.xyxy):
                obj = res.names[int(cls)]
                m = mask.cpu().numpy() > 0.5
                if m.shape != (H, W):
                    m = resize_nearest(m.astype(np.uint8), W, H) > 0
                frame_masks[obj] |= m
                frame_boxes[obj] = np.asarray(box.cpu(), np.float32)
                union |= m
        union_masks.append(union)
        f = feats_cache[v]  # [144, 20, 20]
        for obj in names:
            per_obj[obj]["masks"].append(frame_masks[obj])
            per_obj[obj]["boxes"].append(frame_boxes[obj])
            m20 = resize_linear_u8(frame_masks[obj].astype(np.uint8), 20, 20) > 0
            per_obj[obj]["feats"].append(f[:, m20].mean(-1) if m20.any() else np.zeros(f.shape[0], np.float32))

    out: Dict = {"names": names + ["background"]}
    for obj in names:
        out[f"{obj}__masks"] = np.stack(per_obj[obj]["masks"])
        out[f"{obj}__feats"] = np.stack(per_obj[obj]["feats"]).astype(np.float32)
        out[f"{obj}__bboxes"] = np.stack(per_obj[obj]["boxes"])
    out["background__masks"] = ~np.stack(union_masks)
    out["background__feats"] = np.stack([f.mean((-2, -1)) for f in feats_cache]).astype(np.float32)
    out["background__bboxes"] = np.full((V, 4), -1.0, np.float32)
    return out


def preprocess_scene(
    scene_dir: str,
    splits=("train", "val", "test"),
    model_name: str = "yolov8s-seg.pt",
    disable_yolo: bool = False,
):
    """Write <scene>/yolo/<split>.npz for every split that has images."""
    out_dir = os.path.join(scene_dir, "yolo")
    os.makedirs(out_dir, exist_ok=True)
    run_yolo = not disable_yolo and yolo_available()
    if not disable_yolo and not run_yolo:
        print("[yolo] ultralytics is not installed: writing background-only masks (the disable_yolo mode)")
    for split in splits:
        tj = os.path.join(scene_dir, f"transforms_{split}.json")
        if not os.path.exists(tj):
            tj = os.path.join(scene_dir, "transforms.json")
            if not os.path.exists(tj):
                continue
        with open(tj) as f:
            frames = json.load(f)["frames"]
        paths = []
        for fr in frames:
            p = os.path.join(scene_dir, fr["file_path"])
            if not os.path.splitext(p)[1]:
                p += ".png"
            if os.path.exists(p):
                paths.append(p)
        if not paths:
            continue
        if run_yolo:
            data = run_yolo_on_frames(paths, model_name)
        else:
            h, w = read_image(paths[0]).shape[:2]
            data = background_only_masks(paths, h, w)
        names = data.pop("names")
        rel_paths = np.array([os.path.relpath(p, scene_dir) for p in paths])
        np.savez_compressed(
            os.path.join(out_dir, f"{split}.npz"), names=names, paths=rel_paths, **data
        )
        print(f"[yolo] wrote {split}.npz with objects: {names}")


def load_sidecar(scene_dir: str, split: str) -> Optional[Dict]:
    path = os.path.join(scene_dir, "yolo", f"{split}.npz")
    if not os.path.exists(path):
        return None
    data = np.load(path, allow_pickle=False)
    if "paths" not in data.files:
        raise ValueError(
            f"{path} has no 'paths' key (written by an old preprocessing run); "
            "regenerate the sidecar so masks align to frames by path"
        )
    return {k: data[k] for k in data.files}
