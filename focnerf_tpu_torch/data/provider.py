"""Dataset provider: transforms.json scenes -> training batches and views.

Twin of focnerf_tpu/data/provider.py (nerf/provider.py:91-459):
blender/colmap layout autodetect, ``nerf_matrix_to_ngp`` poses, the colmap
slerp test path, per-object masking from the YOLO sidecar (aligned to
frames by path), intrinsics from fl_x/fl_y or camera angles, ``eval_view``
and, for training, ``train_batch``: the images, masks and object features
are preloaded on the device and a batch (one random view, ``num_rays``
pixels drawn uniformly, as ``patch_size`` patches, or by the view's error
map, their rays and GT) is gathered there by ``make_batch_assemble`` from
the draws ``batch_draws`` makes with a ``torch.Generator``; the fused K-step
chunk stages K steps' draws and runs the same assembler. With ``error_map`` the train split keeps the
per-view map ``error_map`` [n_views, 128 * 128], filled with 0.1, which the
trainer updates after every step. With ``host_pipeline`` (``--no-preload``,
JAX's :267-288, :376-410) the train split stays on the host as a uint8
[V, H*W, C] stack (``images_host``), the native threaded loader
(data/native_loader.py) draws each batch's view, indices and pixels there,
and the rays, mask and object feature are built on the device from them;
it samples uniformly (no error map, no patches). ``rand_pose_batch`` makes
the GT-free batch of the CLIP branch: one random pose at ``radius``,
rendered at 1/s of the image side so it holds about ``num_rays`` rays.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from focnerf_tpu_torch.core.camera import nerf_matrix_to_ngp, rand_poses
from focnerf_tpu_torch.core.rays import ERROR_MAP_RES, get_rays, index_draws, sample_ray_indices
from focnerf_tpu_torch.data.png import read_image


def make_batch_assemble(H: int, W: int, num_rays: int, intrinsics, patch_size: int = 1):
    """The on-device batch assembler (JAX's ``make_batch_assemble``):
    ``assemble(draws, poses, images, masks, obj_feats, error_map)`` -> dict
    (rays_o, rays_d [N, 3], pixels [N, C] f32, ray_mask [N] bool when
    ``masks`` is given, obj_feat [F] when ``obj_feats`` is, view, and
    inds_coarse [N] with an error map). ``draws`` are ``batch_draws``'s
    tensors (the view [1] and the index draws); the error map is read at
    the view's row. No host sync, no data-dependent shape: a CUDA graph
    holds it."""

    def assemble(draws, poses, images, masks, obj_feats, error_map):
        view = draws["view"]
        em = None if error_map is None else error_map.index_select(0, view)[0]
        inds, inds_coarse = sample_ray_indices(H, W, num_rays, draws, error_map=em, patch_size=patch_size)
        flat = view * (H * W) + inds  # rows of the [V * H * W] pixel stack
        rays = get_rays(poses.index_select(0, view)[0], intrinsics, H, W, inds=inds, device=poses.device)
        batch = {
            "rays_o": rays["rays_o"],
            "rays_d": rays["rays_d"],
            "pixels": images.reshape(-1, images.shape[-1])[flat].float(),
            "view": view[0],
        }
        if masks is not None:
            batch["ray_mask"] = masks.reshape(-1)[flat]
        if obj_feats is not None:
            batch["obj_feat"] = obj_feats.index_select(0, view)[0]
        if inds_coarse is not None:
            batch["inds_coarse"] = inds_coarse
        return batch

    return assemble


@dataclasses.dataclass
class DatasetOptions:
    path: str
    scale: float = 0.33
    offset: tuple = (0.0, 0.0, 0.0)
    downscale: int = 1
    num_rays: int = 4096
    preload_dtype: str = "float32"  # or "float16" (-O)
    edit_x: float = 0.0  # camera x-shift for editing previews
    rand_pose: int = -1  # <0: never, 0: always, >0: every Nth batch
    radius: float = 5.0  # rand-pose orbit radius
    error_map: bool = False  # error-map importance sampling (train split)
    patch_size: int = 1  # > 1: sample patch_size x patch_size patches
    # keep the train split on the host as uint8 and draw batches with the
    # native threaded loader instead of preloading it to the device
    host_pipeline: bool = False


def _load_image(path: str) -> np.ndarray:
    img = read_image(path)
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    if img.dtype == np.uint16:
        return img.astype(np.float32) / 65535.0
    return img.astype(np.float32)


def _resize(img: np.ndarray, H: int, W: int, nearest: bool = False) -> np.ndarray:
    """Integer-factor downscale: box average (cv2 INTER_AREA) or nearest."""
    h, w = img.shape[:2]
    if h % H or w % W or h // H != w // W:
        raise ValueError(f"can only downscale {h}x{w} by an integer factor, not to {H}x{W}")
    f = h // H
    if nearest:
        return img[f // 2 :: f, f // 2 :: f]
    return img.reshape(H, f, W, f, *img.shape[2:]).mean(axis=(1, 3))


def _slerp(p0: np.ndarray, p1: np.ndarray, ratio: float) -> np.ndarray:
    """Pose interpolation for the colmap synthetic test split (provider.py:174-195)."""
    from scipy.spatial.transform import Rotation, Slerp

    rots = Rotation.from_matrix(np.stack([p0[:3, :3], p1[:3, :3]]))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = Slerp([0, 1], rots)(ratio).as_matrix()
    pose[:3, 3] = (1 - ratio) * p0[:3, 3] + ratio * p1[:3, 3]
    return pose


class NeRFDataset:
    """Loads one split of a scene; images and features live on ``device``."""

    def __init__(
        self,
        opt: DatasetOptions,
        split: str = "test",
        mask_details: Optional[Dict] = None,
        detected_object: str = "background",
        n_test: int = 10,
        device=None,
    ):
        from focnerf_tpu_torch import resolve_device

        self.device = resolve_device(device)
        self.opt = opt
        self.split = split
        self.detected_object = detected_object
        root = opt.path

        if os.path.exists(os.path.join(root, "transforms.json")):
            self.mode = "colmap"
            tj = os.path.join(root, "transforms.json")
        elif os.path.exists(os.path.join(root, f"transforms_{split}.json")):
            self.mode = "blender"
            tj = os.path.join(root, f"transforms_{split}.json")
        elif split == "val" and os.path.exists(os.path.join(root, "transforms_test.json")):
            self.mode = "blender"
            tj = os.path.join(root, "transforms_test.json")
        else:
            raise FileNotFoundError(f"no transforms json found under {root}")
        with open(tj) as f:
            transform = json.load(f)

        self.H = self.W = None
        if "h" in transform and "w" in transform:
            self.H = int(transform["h"]) // opt.downscale
            self.W = int(transform["w"]) // opt.downscale

        frames = sorted(transform["frames"], key=lambda d: d["file_path"])
        poses: List[np.ndarray] = []
        images: List[np.ndarray] = []
        self.paths: List[str] = []

        def image_path(fr):
            p = os.path.join(root, fr["file_path"])
            return p if os.path.splitext(p)[1] else p + ".png"

        if self.mode == "colmap" and split == "test":
            rng = np.random.default_rng(0)
            i0, i1 = rng.choice(len(frames), 2, replace=False)
            f0 = nerf_matrix_to_ngp(np.array(frames[i0]["transform_matrix"], np.float32),
                                    opt.scale, opt.offset)
            f1 = nerf_matrix_to_ngp(np.array(frames[i1]["transform_matrix"], np.float32),
                                    opt.scale, opt.offset)
            for i in range(n_test + 1):
                ratio = np.sin(((i / n_test) - 0.5) * np.pi) * 0.5 + 0.5
                poses.append(_slerp(f0, f1, ratio))
            if self.H is None:
                for fr in frames:
                    if os.path.exists(image_path(fr)):
                        img = _load_image(image_path(fr))
                        self.H = img.shape[0] // opt.downscale
                        self.W = img.shape[1] // opt.downscale
                        break
        else:
            if self.mode == "colmap" and split in ("train", "val"):
                frames = frames[1:] if split == "train" else frames[:1]
            for fr in frames:
                pose = nerf_matrix_to_ngp(np.array(fr["transform_matrix"], np.float32),
                                          opt.scale, opt.offset)
                if opt.edit_x:
                    pose[0, 3] += opt.edit_x
                path = image_path(fr)
                if not os.path.exists(path):
                    continue
                img = _load_image(path)
                if self.H is None:
                    self.H = img.shape[0] // opt.downscale
                    self.W = img.shape[1] // opt.downscale
                if img.shape[0] != self.H or img.shape[1] != self.W:
                    img = _resize(img, self.H, self.W)
                if img.ndim == 2:
                    img = np.repeat(img[..., None], 3, axis=-1)
                poses.append(pose)
                images.append(img.astype(np.float32))
                self.paths.append(path)

        self.poses = np.stack(poses).astype(np.float32)  # [V, 4, 4]
        self.n_views = len(self.poses)

        self.obj_feats = None
        self.masks = None
        if mask_details is not None and images:
            images = self._apply_masks(images, mask_details, root)

        self.training = split in ("train", "all", "trainval")
        self.images = None
        self.images_host: Optional[np.ndarray] = None
        self._native_loader = None
        if images:
            from focnerf_tpu_torch.data import native_loader

            arr = np.stack(images).reshape(self.n_views, -1, images[0].shape[-1])
            host = opt.host_pipeline and self.training
            if host and not native_loader.available():
                print("[WARN] native loader unavailable; preloading to device")
                host = False
            if host:
                if opt.error_map or opt.patch_size > 1:
                    raise ValueError("host_pipeline samples uniformly (no error-map/patch modes)")
                self.images_host = np.ascontiguousarray(
                    np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8))
            else:
                dtype = torch.float16 if opt.preload_dtype == "float16" else torch.float32
                self.images = torch.as_tensor(arr).to(self.device, dtype)
        self.poses_dev = torch.as_tensor(self.poses).to(self.device)
        self.masks_dev = None
        if self.masks is not None:
            self.masks_dev = torch.as_tensor(self.masks.reshape(self.n_views, -1)).to(self.device)
        self.obj_feats_dev = None
        if self.obj_feats is not None:
            self.obj_feats_dev = torch.as_tensor(self.obj_feats).to(self.device)

        t = transform
        if "fl_x" in t or "fl_y" in t:
            fl_x = (t.get("fl_x") or t.get("fl_y")) / opt.downscale
            fl_y = (t.get("fl_y") or t.get("fl_x")) / opt.downscale
        elif "camera_angle_x" in t or "camera_angle_y" in t:
            fl_x = self.W / (2 * np.tan(t["camera_angle_x"] / 2)) if "camera_angle_x" in t else None
            fl_y = self.H / (2 * np.tan(t["camera_angle_y"] / 2)) if "camera_angle_y" in t else None
            fl_x = fl_x if fl_x is not None else fl_y
            fl_y = fl_y if fl_y is not None else fl_x
        else:
            raise RuntimeError("no focal length in transforms json")
        cx = t["cx"] / opt.downscale if "cx" in t else self.W / 2
        cy = t["cy"] / opt.downscale if "cy" in t else self.H / 2
        self.intrinsics = np.array([fl_x, fl_y, cx, cy], np.float32)
        self.error_map = None
        if opt.error_map and split in ("train", "all", "trainval"):
            self.error_map = torch.full((self.n_views, ERROR_MAP_RES**2), 0.1, device=self.device)

    def _apply_masks(self, images, mask_details, root):
        """Object mask -> alpha channel; per-view features from the sidecar."""
        masks_arr = np.asarray(mask_details["masks"])
        feats_arr = (
            np.asarray(mask_details["feats"], np.float32)
            if mask_details.get("feats") is not None
            else np.zeros((len(images), 144), np.float32)
        )
        row_of = None
        if mask_details.get("paths") is not None:
            row_of = {os.path.normpath(str(p)): i for i, p in enumerate(mask_details["paths"])}
        masked, feats, msks = [], [], []
        for i, img in enumerate(images):
            if row_of is not None:
                key = os.path.normpath(os.path.relpath(self.paths[i], root))
                if key not in row_of:
                    raise KeyError(f"yolo sidecar has no row for image {key}")
                i = row_of[key]
            mask = masks_arr[i] if i < len(masks_arr) else np.ones((self.H, self.W), bool)
            if mask.shape != (self.H, self.W):
                mask = _resize(mask, self.H, self.W, nearest=True)
            feat = feats_arr[i] if i < len(feats_arr) else np.zeros(144, np.float32)
            masked.append(np.concatenate([img[..., :3], mask[..., None].astype(np.float32)], -1))
            feats.append(feat)
            msks.append(mask)
        self.obj_feats = np.stack(feats)  # [V, F]
        self.masks = np.stack(msks)  # [V, H, W] bool
        return masked

    def batch_draws(self, generator: torch.Generator) -> dict:
        """The random numbers of one ``train_batch`` from ``generator``: the
        view ``view`` [1], then ``index_draws``'s (the pixels, patch
        corners or error-map draws)."""
        draws = {"view": torch.randint(0, self.n_views, (1,), generator=generator, device=self.device)}
        draws.update(index_draws(generator, self.H, self.W, self.opt.num_rays,
                                 error_map=self.error_map is not None,
                                 patch_size=self.opt.patch_size, device=self.device))
        return draws

    def assemble_fn(self):
        """The batch assembler of this split's shapes, shared by the
        per-step path and the fused K-step chunk (train/fused.py), so both
        make the same batches: ``make_batch_assemble``'s function."""
        return make_batch_assemble(self.H, self.W, self.opt.num_rays, self.intrinsics,
                                   patch_size=self.opt.patch_size)

    def fused_batch_inputs(self):
        """The device tensors the assembler reads, in its order: poses,
        images, masks (or None), object features (or None)."""
        return (self.poses_dev, self.images, self.masks_dev, self.obj_feats_dev)

    def train_batch(self, generator: torch.Generator, draws: Optional[dict] = None) -> dict:
        """One training batch drawn from ``generator`` (on the dataset's
        device): a random view and ``num_rays`` pixels of it (uniform, in
        patches, or by the view's error map), their rays and GT ->
        ``make_batch_assemble``'s dict. ``draws``: ``batch_draws``'s, instead
        of drawing them. Everything stays on the device: no host sync."""
        if self.images_host is not None:
            if draws is not None:
                raise ValueError("host_pipeline samples its own views and indices (draws=None)")
            return self._host_train_batch()
        if self.images is None:
            raise ValueError(f"split {self.split!r} has no images to train on")
        if draws is None:
            draws = self.batch_draws(generator)
        return self.assemble_fn()(draws, *self.fused_batch_inputs(), self.error_map)

    def _host_train_batch(self) -> dict:
        """One batch from the native loader (started at the first call, two
        worker threads, seed 1234, as JAX's): the view, indices and pixels
        come from the host; rays, mask and object feature are built on the
        device, in ``train_batch``'s keys."""
        from focnerf_tpu_torch.data.native_loader import NativeBatchLoader

        if self._native_loader is None:
            self._native_loader = NativeBatchLoader(self.images_host, self.opt.num_rays, n_threads=2, seed=1234)
        v, inds, pixels = self._native_loader.next()
        inds = torch.from_numpy(inds.astype(np.int64)).to(self.device)
        view = torch.tensor(v, device=self.device)
        rays = get_rays(self.poses_dev[v], self.intrinsics, self.H, self.W, inds=inds, device=self.device)
        batch = {
            "rays_o": rays["rays_o"],
            "rays_d": rays["rays_d"],
            "pixels": torch.from_numpy(pixels).to(self.device),
            "view": view,
        }
        if self.masks_dev is not None:
            batch["ray_mask"] = self.masks_dev[v][inds]
        if self.obj_feats_dev is not None:
            batch["obj_feat"] = self.obj_feats_dev[v]
        return batch

    def close(self) -> None:
        """Stop the native loader's threads, if they were started."""
        if self._native_loader is not None:
            self._native_loader.close()
            self._native_loader = None

    def rand_pose_batch(self, rng_np: np.random.Generator) -> dict:
        """GT-free random-pose batch for CLIP-guided training (provider.py:
        404-418): one pose from ``rng_np`` at ``radius``, the intrinsics over
        s = int(sqrt(H * W / num_rays)) -> dict(rays_o, rays_d [H/s * W/s,
        3], H, W)."""
        s = int(np.sqrt(self.H * self.W / self.opt.num_rays))
        rH, rW = self.H // s, self.W // s
        pose = rand_poses(rng_np, 1, radius=self.opt.radius)[0]
        rays = get_rays(pose, self.intrinsics / s, rH, rW, device=self.device)
        return {"rays_o": rays["rays_o"], "rays_d": rays["rays_d"], "H": rH, "W": rW}

    def eval_view(self, view: int) -> dict:
        """Pose, size, GT pixels and object feature of one view."""
        out = {"pose": self.poses[view], "H": self.H, "W": self.W}
        if self.images is not None:
            out["pixels"] = self.images[view].float()
        elif self.images_host is not None:
            out["pixels"] = torch.from_numpy(self.images_host[view].astype(np.float32) / 255.0).to(self.device)
        if self.obj_feats is not None:
            out["obj_feat"] = torch.as_tensor(self.obj_feats[view], device=self.device)
        return out
