"""The benchmark's frozen inputs: the hard static scene, written once per checkout.

``hard_volume`` is a frozen copy of the repository's procedural object (a
wireframe cube of thin struts, a 3x3 pillar grid on a floor plate, a
textured centre sphere), so a change to the program's own generator cannot
move the benchmark's inputs. ``render_volume`` is a plain ray marcher
through that volume (trilinear ``grid_sample``, 0.4-voxel steps). The
scene is fixed: geometry and cameras come from seed 0 and never from a
run's ``--seed``.

``ensure_scene`` writes a blender-layout scene (``transforms_<split>.json``
with ``fl_x``/``fl_y``, RGBA PNGs) under ``portbench/.cache/<name>/``,
beside ``arrays.npz``: the same uint8 RGBA stacks, the ngp poses and the
intrinsics, which the reference reads, and ``occupancy.npy``, the serving
cells' occupancy grid (a cell is occupied where the volume holds any
density). A finished scene is kept; a half-written one is never read
(``done.json`` is written last).

Imports torch, numpy and the standard library only.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import struct
import zlib

import numpy as np
import torch

VERSION = 1


def hard_volume(R: int = 256, bound: float = 1.0) -> np.ndarray:
    """rgb + sigma [R, R, R, 4] over [-bound, bound]^3 (x-major), numpy."""
    c = (np.arange(R, dtype=np.float32) + 0.5) / R * 2 * bound - bound
    X, Y, Z = np.meshgrid(c, c, c, indexing="ij")
    e = 0.6
    w = 1.6 * (2 * bound / R)
    near_e = lambda A: np.abs(np.abs(A) - e) < w  # noqa: E731
    inside = lambda A: np.abs(A) < e + w  # noqa: E731
    frame = ((near_e(X) & near_e(Y) & inside(Z)) | (near_e(X) & near_e(Z) & inside(Y))
             | (near_e(Y) & near_e(Z) & inside(X)))
    plate = (np.abs(Z + e) < w) & (np.abs(X) < e + w) & (np.abs(Y) < e + w)
    pillars = np.zeros_like(frame)
    for px in (-0.3, 0.0, 0.3):
        for py in (-0.3, 0.0, 0.3):
            pillars |= ((X - px) ** 2 + (Y - py) ** 2 < w**2 * 4) & (np.abs(Z) < e)
    sphere = X**2 + Y**2 + Z**2 < 0.25**2
    sigma = np.where(frame | pillars | plate | sphere, 60.0, 0.0).astype(np.float32)
    f = 12.0 * np.pi / bound
    checker = 0.5 + 0.5 * np.sign(np.sin(f * X) * np.sin(f * Y) * np.sin(f * Z))
    stripes = 0.5 + 0.5 * np.sin(2.5 * f * (X + Y + Z) / 3.0)
    r = np.where(sphere, stripes, checker)
    g = np.where(frame | plate, 0.85, 0.25 + 0.5 * stripes)
    b = np.where(pillars, 0.9, 1.0 - checker)
    return np.concatenate([np.stack([r, g, b], -1), sigma[..., None]], -1).astype(np.float32)


def look_at_poses(centers: np.ndarray) -> np.ndarray:
    """Camera-to-world [n, 4, 4] (columns right, down, forward: the ngp
    convention) of cameras at ``centers`` looking at the origin, +y up."""
    fwd = -centers / np.linalg.norm(centers, axis=-1, keepdims=True)
    right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right /= np.linalg.norm(right, axis=-1, keepdims=True)
    down = np.cross(fwd, right)
    poses = np.tile(np.eye(4), (len(centers), 1, 1))
    poses[:, :3, :3] = np.stack([right, down, fwd], -1)
    poses[:, :3, 3] = centers
    return poses.astype(np.float32)


def sphere_poses(rng: np.random.Generator, n: int, radius: float) -> np.ndarray:
    theta = rng.uniform(np.pi / 3, 2 * np.pi / 3, n)
    phi = rng.uniform(0.0, 2 * np.pi, n)
    c = np.stack([np.sin(theta) * np.sin(phi), np.cos(theta), np.sin(theta) * np.cos(phi)], -1)
    return look_at_poses(radius * c)


def orbit_poses(n: int, radius: float, elevation: float = 0.3) -> np.ndarray:
    """``n`` cameras evenly spaced on a circle ``elevation`` rad above the equator."""
    phi = np.arange(n) * 2 * np.pi / n
    c = np.stack([np.cos(elevation) * np.sin(phi), -np.sin(elevation) * np.ones(n),
                  np.cos(elevation) * np.cos(phi)], -1)
    return look_at_poses(radius * c)


def ngp_to_nerf(ngp: np.ndarray) -> np.ndarray:
    """The OpenGL-convention pose that nerf_matrix_to_ngp (scale 1, offset 0)
    maps to ``ngp``: rows permuted (x, y, z) <- (z, x, y), y and z axes negated."""
    out = np.eye(4, dtype=np.float32)
    flip = np.array([1, -1, -1], np.float32)
    out[1, :3], out[2, :3], out[0, :3] = ngp[0, :3] * flip, ngp[1, :3] * flip, ngp[2, :3] * flip
    out[1, 3], out[2, 3], out[0, 3] = ngp[0, 3], ngp[1, 3], ngp[2, 3]
    return out


def _volume_tensor(vol: np.ndarray, device) -> torch.Tensor:
    """[R, R, R, 4] (x, y, z) -> [1, 4, Z, Y, X] for grid_sample."""
    return torch.from_numpy(vol).to(device).permute(3, 2, 1, 0)[None].contiguous()


@torch.no_grad()
def render_volume(vol_t: torch.Tensor, extent: float, pose: np.ndarray, focal: float, H: int, W: int,
                  chunk: int = 1 << 15) -> np.ndarray:
    """RGBA [H, W, 4] of the volume (spanning [-extent, extent]^3) from a
    pinhole camera, rgb composited on white, by plain emission-absorption
    marching at 0.4 of a voxel per step."""
    device = vol_t.device
    R = vol_t.shape[-1]
    step = 0.4 * 2 * extent / R
    p = torch.from_numpy(pose).to(device).double()
    j, i = torch.meshgrid(torch.arange(H, device=device), torch.arange(W, device=device), indexing="ij")
    dirs = torch.stack([(i + 0.5 - W / 2) / focal, (j + 0.5 - H / 2) / focal, torch.ones_like(i)], -1)
    dirs = dirs.reshape(-1, 3).double()
    dirs = (dirs / dirs.norm(dim=-1, keepdim=True)) @ p[:3, :3].T
    o = p[:3, 3]
    dist = float(o.norm())
    t = torch.arange(max(dist - extent * math.sqrt(3), 0.0), dist + extent * math.sqrt(3), step, device=device)
    out = []
    for s in range(0, dirs.shape[0], chunk):
        d = dirs[s:s + chunk]
        pts = (o + d[:, None, :] * t[None, :, None]) / extent  # [n, S, 3] in [-1, 1]
        smp = torch.nn.functional.grid_sample(vol_t, pts.float()[None, None], align_corners=False)
        smp = smp[0, :, 0].permute(1, 2, 0)  # [n, S, 4]
        a = 1.0 - torch.exp(-smp[..., 3] * step / extent)
        trans = torch.cumprod(torch.cat([torch.ones_like(a[:, :1]), 1.0 - a[:, :-1]], 1), 1)
        w = a * trans
        alpha = w.sum(1)
        rgb = (w[..., None] * smp[..., :3]).sum(1) + (1.0 - alpha)[:, None]
        out.append(torch.cat([rgb, alpha[:, None]], -1))
    return torch.cat(out).reshape(H, W, 4).clamp(0, 1).cpu().numpy()


@torch.no_grad()
def occupancy_from_volume(vol_t: torch.Tensor, extent: float, bound: float, H: int = 128, sub: int = 4):
    """uint8 [CAS, H^3] (x-major cells; cascade c spans min(2^c, bound)):
    1 where any of the cell's sub^3 sample points sees density."""
    n_cas = 1 + math.ceil(math.log2(max(bound, 1.0)))
    out = []
    for cas in range(n_cas):
        cb = min(2.0**cas, bound)
        n = H * sub
        c = ((torch.arange(n, device=vol_t.device, dtype=torch.float32) + 0.5) / n * 2 - 1) * cb / extent
        occ = torch.zeros((H, H, H), dtype=torch.bool, device=vol_t.device)
        for xs in range(0, n, sub * 8):  # slabs of x to bound the memory
            cx = c[xs:xs + sub * 8]
            Z, Y, X = torch.meshgrid(c, c, cx, indexing="ij")
            pts = torch.stack([X, Y, Z], -1)[None]  # [1, n, n, nx, 3]: grid_sample's (x, y, z)
            sig = torch.nn.functional.grid_sample(vol_t[:, 3:], pts, align_corners=False)[0, 0]
            # [z, y, x] -> cells
            cell = sig.reshape(H, sub, H, sub, -1, sub).amax((1, 3, 5)) > 0  # [z, y, x]
            occ[xs // sub:xs // sub + cell.shape[-1]] = cell.permute(2, 1, 0)
        out.append(occ.reshape(-1))
    return torch.stack(out).to(torch.uint8).cpu().numpy()


def _png(arr: np.ndarray) -> bytes:
    """uint8 [H, W, 4] -> RGBA PNG bytes (filter 0 on every row)."""
    H, W, C = arr.shape
    raw = np.concatenate([np.zeros((H, 1), np.uint8), arr.reshape(H, W * C)], 1).tobytes()

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 6, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def ensure_scene(spec: dict, device, cache: str) -> str:
    """The scene of ``spec`` (name, H, W, views per split, gt_res, extent,
    radius, bound) under ``cache``, rendered on ``device`` unless already
    written -> its directory."""
    root = os.path.join(cache, spec["name"])
    want = dict(spec, version=VERSION)
    done = os.path.join(root, "done.json")
    if os.path.exists(done):
        with open(done) as f:
            if json.load(f) == want:
                return root
    tmp = root + ".partial"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    vol = hard_volume(spec["gt_res"])
    vol_t = _volume_tensor(vol, device)
    H, W = spec["H"], spec["W"]
    focal = 1.2 * W
    rng = np.random.default_rng(0)
    arrays = {"intrinsics": np.array([focal, focal, W / 2.0, H / 2.0], np.float32)}
    for split in ("train", "val", "test"):
        n = spec[f"n_{split}"]
        poses = orbit_poses(n, spec["radius"]) if split == "test" else sphere_poses(rng, n, spec["radius"])
        os.makedirs(os.path.join(tmp, split))
        frames, rgba = [], []
        for i, pose in enumerate(poses):
            img = (render_volume(vol_t, spec["extent"], pose, focal, H, W) * 255.0 + 0.5).astype(np.uint8)
            with open(os.path.join(tmp, split, f"r_{i:03d}.png"), "wb") as f:
                f.write(_png(img))
            frames.append({"file_path": f"{split}/r_{i:03d}", "transform_matrix": ngp_to_nerf(pose).tolist()})
            rgba.append(img)
        with open(os.path.join(tmp, f"transforms_{split}.json"), "w") as f:
            json.dump({"fl_x": focal, "fl_y": focal, "cx": W / 2.0, "cy": H / 2.0, "h": H, "w": W,
                       "frames": frames}, f)
        arrays[f"{split}_rgba"] = np.stack(rgba)
        arrays[f"{split}_poses"] = poses
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    np.save(os.path.join(tmp, "occupancy.npy"),
            occupancy_from_volume(vol_t, spec["extent"], spec["bound"]))
    with open(os.path.join(tmp, "done.json"), "w") as f:
        json.dump(want, f)
    shutil.rmtree(root, ignore_errors=True)
    os.replace(tmp, root)
    return root


def load_arrays(root: str, split: str) -> dict:
    """The reference's view of a split: uint8 RGBA [V, H, W, 4], ngp poses, intrinsics."""
    with np.load(os.path.join(root, "arrays.npz")) as z:
        return {"rgba": z[f"{split}_rgba"], "poses": z[f"{split}_poses"], "intrinsics": z["intrinsics"]}
