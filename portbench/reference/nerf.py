"""The plain reference of the FOC-NeRF field and its -O training step.

Plain PyTorch, written from the published methods and not from the program
under test: the Instant-NGP multiresolution hash encoding (Mueller et al.
2022, section 3; torch-ngp's gridencoder layout: per-level scale
``2^(l log2 b) N_min - 1``, a +0.5 offset, XOR-prime hashing of levels
whose dense grid outgrows the table, rows padded to multiples of 8), the
real spherical harmonics of degree 4 (tiny-cuda-nn's basis), bias-free
ReLU MLPs, ``trunc_exp`` density, sigmoid colour, torch-ngp's occupancy
grid (cascades, mip level from ``frexp``, the full refresh of the first
updates, cells no training camera sees marked -1) and its ray march along
the lattice ``t += clamp(t * dt_gamma, dt_min, dt_max)``, emission-
absorption compositing with early termination at ``T < T_thresh``, the
masked-object loss, and Adam with torch-ngp's schedule.

Precision follows the configuration: MLP operands are rounded to
``dtype`` (bf16 under -O; the cotangents too, as ``torch.autocast``'s
backward rounds them) and products accumulate in fp32; rays, the slab test
and the march run in fp32 as torch-ngp's ``get_rays`` and
``raymarching.cu`` compute them. ``dtype`` float8_e4m3fn gives the
lower-precision control: each operand is scaled so that its largest
magnitude meets e4m3's largest value and rounded in the forward pass only
(a straight-through cast), so the backward sees the fp8 operands' products
and no cotangent is flushed to zero.

Imports torch, numpy and the standard library only.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

PRIMES = (1, 2654435761, 805459861)
SQRT3 = math.sqrt(3.0)
MISS_T = 3.0e38


# ---------------------------------------------------------------- the grid
class GridLayout:
    """Rows, resolutions and scales of a hash grid of ``num_levels`` levels
    over [0, 1]^3, finest resolution ``desired_resolution``."""

    def __init__(self, num_levels, level_dim, base_resolution, log2_hashmap_size, desired_resolution):
        self.L, self.C = num_levels, level_dim
        self.pls = float(np.exp2(np.log2(desired_resolution / base_resolution) / (num_levels - 1)))
        self.res, self.offsets, self.hashed, self.scales = [], [0], [], []
        cap = 2**log2_hashmap_size
        for lvl in range(num_levels):
            res = int(np.ceil(base_resolution * self.pls**lvl))
            dense = (res + 1) ** 3
            self.res.append(res)
            self.hashed.append(dense > cap)
            self.offsets.append(self.offsets[-1] + int(np.ceil(min(cap, dense) / 8) * 8))
            self.scales.append(float(np.float32(np.exp2(lvl * np.log2(self.pls)) * base_resolution - 1.0)))

    @property
    def rows(self) -> int:
        return self.offsets[-1]

    def corner_rows(self, coords: torch.Tensor, lvl: int) -> torch.Tensor:
        """Integer corner coords [..., 3] int64 -> table rows [...]."""
        size = self.offsets[lvl + 1] - self.offsets[lvl]
        if self.hashed[lvl]:
            h = torch.zeros(coords.shape[:-1], dtype=torch.int64, device=coords.device)
            for d in range(3):
                h = h ^ ((coords[..., d] * PRIMES[d]) & 0xFFFFFFFF)
            idx = h % size
        else:
            r = self.res[lvl] + 1
            idx = coords[..., 0] + coords[..., 1] * r + coords[..., 2] * r * r
        return idx + self.offsets[lvl]


def layout_of(cfg: dict) -> GridLayout:
    return GridLayout(cfg["num_levels"], cfg["level_dim"], cfg["base_resolution"], cfg["log2_hashmap_size"],
                      cfg["finest_resolution_per_bound"] * cfg["bound"])


_BITS = torch.tensor([[(c >> d) & 1 for d in range(3)] for c in range(8)], dtype=torch.int64)


def encode(table: torch.Tensor, x01: torch.Tensor, grid: GridLayout, u: Optional[torch.Tensor] = None,
           chunk: int = 1 << 20) -> torch.Tensor:
    """Hash encoding of points x01 [N, 3] in [0, 1] -> [N, L * C].

    Exact: the 8 corners by their trilinear weights. With ``u`` [N, L, 1, 3]
    (-O's stochastic corners, one a level): each axis takes its upper
    corner where ``u < frac`` and the corner's feature enters with weight 1.
    Points outside [0, 1] encode to 0. Differentiable in ``table``."""
    outs = []
    for s in range(0, x01.shape[0], chunk):
        x = x01[s:s + chunk].float()
        inside = ((x >= 0) & (x <= 1)).all(-1, keepdim=True).float()
        x = x.clamp(0.0, 1.0)
        feats = []
        for lvl in range(grid.L):
            pos = x * grid.scales[lvl] + 0.5
            base = torch.floor(pos)
            frac = pos - base
            base = base.to(torch.int64)
            if u is None:
                bits = _BITS.to(x.device)
                w = torch.where(bits[None] > 0, frac[:, None, :], 1.0 - frac[:, None, :]).prod(-1)
                rows = grid.corner_rows(base[:, None, :] + bits[None], lvl)
                feats.append((w[..., None] * table[rows]).sum(1))
            else:
                bits = (u[s:s + chunk, lvl, 0] < frac).to(torch.int64)
                feats.append(table[grid.corner_rows(base + bits, lvl)])
        outs.append(torch.cat(feats, -1) * inside)
    return torch.cat(outs) if outs else table.new_zeros((0, grid.L * grid.C))


# ---------------------------------------------------------------- the MLPs
FP8 = (torch.float8_e4m3fn,)


def rounded(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and back to fp32. An fp8 type: scaled per
    tensor to its largest finite value, rounded in the forward pass only."""
    if dtype not in FP8:
        return x.to(dtype).float()
    with torch.no_grad():
        scale = torch.finfo(dtype).max / x.abs().amax().float().clamp(min=1e-30)
        q = (x.float() * scale).to(dtype).float() / scale
    return x + (q - x).detach()


def mlp(ws: List[torch.Tensor], x: torch.Tensor, dtype) -> torch.Tensor:
    """Bias-free ReLU MLP, [in, out] weights: operands rounded to ``dtype``,
    fp32 products, hidden activations rounded after the ReLU, fp32 out."""
    h = rounded(x, dtype)
    for i, w in enumerate(ws):
        h = h @ rounded(w, dtype)
        if i < len(ws) - 1:
            h = rounded(torch.relu(h), dtype)
    return h


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(-15.0, 15.0))


def sh4(d: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics of degree 4 (16 terms) of unit directions."""
    x, y, z = d.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.4886025119029199 * y, 0.4886025119029199 * z, -0.4886025119029199 * x,
        1.0925484305920792 * x * y, -1.0925484305920792 * y * z,
        0.94617469575755997 * zz - 0.31539156525251999, -1.0925484305920792 * x * z,
        0.54627421529603959 * (xx - yy),
        0.59004358992664352 * y * (-3.0 * xx + yy), 2.8906114426405538 * x * y * z,
        0.45704579946446572 * y * (1.0 - 5.0 * zz), 0.3731763325901154 * z * (5.0 * zz - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * zz), 1.4453057213202769 * z * (xx - yy),
        0.59004358992664352 * x * (-xx + 3.0 * yy),
    ], -1)


def density(params, cfg, grid, xyz, dtype, u=None):
    """Points [N, 3] in the bound box -> (sigma [N], geometric features [N, 15])."""
    x01 = (xyz + cfg["bound"]) / (2.0 * cfg["bound"])
    h = mlp(params["sigma_net"], encode(params["grid"], x01, grid, u), dtype)
    return _TruncExp.apply(h[:, 0]), h[:, 1:]


def color(params, dirs, geo, obj_enc, dtype):
    """Directions [N, 3], geometric features, the object's 16-wide encoding -> rgb."""
    h = torch.cat([sh4(dirs), geo, obj_enc.expand(dirs.shape[0], obj_enc.shape[-1])], -1)
    return torch.sigmoid(mlp(params["color_net"], h, dtype))


def object_encoding(params, obj_feat, dtype):
    return mlp(params["yolo_net"], obj_feat.reshape(1, -1).float(), dtype)


# ---------------------------------------------------------------- rays
def camera_rays(pose: torch.Tensor, intrinsics, H: int, W: int, inds: torch.Tensor):
    """Pixel centres of flat indices ``inds`` -> (origins, unit directions),
    fp32, as torch-ngp's ``get_rays`` computes them."""
    fx, fy, cx, cy = (float(np.float32(v)) for v in intrinsics)
    pose = pose.float()
    rows = torch.div(inds, W, rounding_mode="floor").float()
    cols = (inds % W).float()
    dirs = torch.stack([(cols + 0.5 - cx) / fx, (rows + 0.5 - cy) / fy, torch.ones_like(cols)], -1)
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    return pose[:3, 3].expand(dirs.shape), dirs @ pose[:3, :3].T


def near_far(o, d, bound: float, min_near: float):
    """Slab test against [-bound, bound]^3 -> (near, far), fp32, by the
    reciprocal direction as raymarching.cu's ``near_far_from_aabb``; a
    miss gets MISS_T for both."""
    o, rd = o.float(), 1.0 / d.float()
    t1 = (-bound - o) * rd
    t2 = (bound - o) * rd
    tmin = torch.minimum(t1, t2).amax(-1)
    tmax = torch.maximum(t1, t2).amin(-1)
    near = tmin.clamp(min=min_near)
    far = torch.maximum(tmax, near)
    miss = tmax < tmin
    return torch.where(miss, MISS_T, near), torch.where(miss, MISS_T, far)


# ---------------------------------------------------------------- the grid of occupancy
def cascades(bound: float) -> int:
    return 1 + math.ceil(math.log2(max(bound, 1.0)))


def cell_centres(cas: int, bound: float, H: int = 128, device="cpu"):
    """World coords of every cell of cascade ``cas`` (x-major), and its half cell."""
    i = torch.arange(H, device=device, dtype=torch.float32)
    c = 2.0 * i / (H - 1) - 1.0
    X, Y, Z = torch.meshgrid(c, c, c, indexing="ij")
    pts = torch.stack([X, Y, Z], -1).reshape(-1, 3)
    cb = min(2.0**cas, bound)
    half = cb / H
    return pts * (cb - half), half


def unseen_cells(poses: torch.Tensor, intrinsics, bound: float, H: int = 128, chunk: int = 1 << 16):
    """[CAS, H^3] bool: cells inside no training camera's frustum."""
    fx, fy, cx, cy = (float(v) for v in intrinsics)
    R, T = poses[:, :3, :3].float(), poses[:, :3, 3].float()
    out = []
    for cas in range(cascades(bound)):
        pts, half = cell_centres(cas, bound, H, poses.device)
        seen = []
        for s in range(0, pts.shape[0], chunk):
            cam = torch.einsum("nbi,bij->nbj", pts[s:s + chunk, None, :] - T[None], R)
            z = cam[..., 2]
            ok = (z > 0) & (cam[..., 0].abs() < cx / fx * z + 2 * half) & (cam[..., 1].abs() < cy / fy * z + 2 * half)
            seen.append(ok.any(1))
        out.append(~torch.cat(seen))
    return torch.stack(out)


@torch.no_grad()
def first_occupancy(params, cfg, grid, poses, intrinsics, jitter, dtype, H: int = 128):
    """The grid after training's first refresh: cells no camera sees -1,
    the rest the field's sigma at a jittered point of the cell (``jitter``
    [CAS, H^3, 3] uniforms) -> (density grid [CAS, H^3], occupied bits)."""
    unseen = unseen_cells(poses, intrinsics, cfg["bound"], H)
    dens = []
    for cas in range(unseen.shape[0]):
        pts, half = cell_centres(cas, cfg["bound"], H, poses.device)
        x = pts + (jitter[cas].float() * 2.0 - 1.0) * half
        sig = torch.cat([density(params, cfg, grid, x[s:s + (1 << 19)], dtype)[0]
                         for s in range(0, x.shape[0], 1 << 19)])
        # max(0 * decay, sigma) where the cell is seen, -1 where not
        dens.append(torch.where(unseen[cas], torch.full_like(sig, -1.0), torch.maximum(sig, torch.zeros_like(sig))))
    grid_d = torch.stack(dens)
    return grid_d, occupied_bits(grid_d, cfg["density_thresh"])


def occupied_bits(density_grid: torch.Tensor, density_thresh: float) -> torch.Tensor:
    mean = density_grid.clamp(min=0).double().mean()
    return density_grid > min(float(mean), density_thresh)


# ---------------------------------------------------------------- the march
def march(o, d, near, far, bits, *, bound: float, dt_gamma: float, max_steps: int, slab: int, noise=None,
          H: int = 128):
    """The first ``slab`` occupied points of each ray on the lattice
    t_{i+1} = t_i + clamp(t_i * dt_gamma, dt_min, dt_max), from t_0 = near
    (+ noise * dt(near)), at most ``max_steps`` lattice points, t < far:
    torch-ngp's march, stepped one lattice point at a time in fp32 (each
    product and sum rounded on its own) -> (ts, dts, valid) [N, slab]."""
    n = o.shape[0]
    dev = o.device
    CAS = bits.shape[0]
    dt_min = 2.0 * SQRT3 / max_steps
    dt_max = 2.0 * SQRT3 * 2.0 ** (CAS - 1) / H
    o, d, near, far = o.float(), d.float(), near.float(), far.float()
    flat_bits = bits.reshape(-1)
    t = near.clone()
    if noise is not None:
        t = t + (near * dt_gamma).clamp(dt_min, dt_max) * noise.float()
    count = torch.zeros(n, dtype=torch.int64, device=dev)
    out_t = torch.zeros((n, slab + 1), device=dev)
    out_dt = torch.zeros((n, slab + 1), device=dev)
    for it in range(max_steps):
        if it % 8 == 0 and not bool(((t < far) & (count < slab)).any()):
            break
        dt = (t * dt_gamma).clamp(dt_min, dt_max)
        xyz = (o + d * t[:, None]).clamp(-bound, bound)
        _, e_pos = torch.frexp(xyz.abs().amax(-1))
        _, e_dt = torch.frexp(dt * H * 0.5)
        level = torch.maximum(e_pos, e_dt).clamp(0, CAS - 1).to(torch.int64)
        mip = torch.exp2(level.float()).clamp(max=bound)
        cell = (0.5 * (xyz / mip[:, None] + 1.0) * H).floor().to(torch.int64).clamp(0, H - 1)
        idx = level * H**3 + cell[:, 0] * H * H + cell[:, 1] * H + cell[:, 2]
        put = flat_bits[idx] & (t < far) & (count < slab)
        col = torch.where(put, count, torch.full_like(count, slab))[:, None]
        out_t.scatter_(1, col, t[:, None])
        out_dt.scatter_(1, col, dt[:, None])
        count = count + put.to(torch.int64)
        t = t + dt
    valid = torch.arange(slab, device=dev)[None] < count[:, None]
    return out_t[:, :slab] * valid, out_dt[:, :slab] * valid, valid


# ---------------------------------------------------------------- compositing
def composite(sigmas, rgbs, dts, ts, bg, T_thresh: float = 1e-4):
    """Emission-absorption along each row -> (image [N, 3], weights sum, depth)."""
    s = dts * sigmas
    excl = torch.cat([torch.zeros_like(s[:, :1]), torch.cumsum(s[:, :-1], -1)], -1)
    trans = torch.exp(-excl)
    w = (1.0 - torch.exp(-s)) * trans
    w = torch.where(trans >= T_thresh, w, torch.zeros_like(w))
    wsum = w.sum(-1)
    image = (w[..., None] * rgbs).sum(-2) + (1.0 - wsum)[:, None] * bg
    return image, wsum, (w * ts).sum(-1)


def render_rays(params, cfg, grid, o, d, bits, obj_feat, dtype, *, slab: int, bg, noise=None, u=None):
    """Rays (fp32 origins and unit directions) through the march, the
    field and the compositor -> dict(image, depth, sigmas [N, slab], count)."""
    near, far = near_far(o, d, cfg["bound"], cfg["min_near"])
    ts, dts, valid = march(o, d, near, far, bits, bound=cfg["bound"], dt_gamma=cfg["dt_gamma"],
                           max_steps=cfg["max_steps"], slab=slab, noise=noise)
    n = o.shape[0]
    rows, cols = valid.nonzero(as_tuple=True)
    xyz = (o[rows] + d[rows] * ts[rows, cols][:, None]).clamp(-cfg["bound"], cfg["bound"]).float()
    uu = None if u is None else u.reshape(n, slab, *u.shape[1:])[rows, cols]
    sig, geo = density(params, cfg, grid, xyz, dtype, uu)
    rgb = color(params, d[rows].float(), geo, object_encoding(params, obj_feat, dtype), dtype)
    sigmas = torch.zeros((n, slab), device=o.device).index_put((rows, cols), sig)
    rgbs = torch.zeros((n, slab, 3), device=o.device).index_put((rows, cols), rgb)
    image, wsum, depth = composite(sigmas, rgbs, dts.float(), ts.float(), bg)
    depth = (depth - near.float()).clamp(min=0.0) / (far - near).float().clamp(min=1e-10)
    return {"image": image, "depth": depth, "sigmas": sigmas, "count": valid.sum(-1)}


# ---------------------------------------------------------------- one training step
def train_loss(params, cfg, grid, batch, bits, draws, dtype, slab: int):
    """The masked-object loss of one batch: per-ray MSE against the RGBA
    target composited on the per-ray background ``bg``, plus 1e-8 times the
    norm of the density sampled on rays outside the object mask."""
    out = render_rays(params, cfg, grid, batch["rays_o"], batch["rays_d"], bits, batch["obj_feat"], dtype,
                      slab=slab, bg=draws["bg"], noise=draws["noise"], u=draws["u"])
    px = batch["pixels"]
    gt = px[:, :3] * px[:, 3:] + draws["bg"] * (1.0 - px[:, 3:])
    loss = ((out["image"] - gt) ** 2).mean(-1).mean()
    outside = torch.where(batch["ray_mask"][:, None], torch.zeros_like(out["sigmas"]), out["sigmas"])
    return loss + cfg["mask_penalty"] * torch.sqrt((outside * outside).sum() + 1e-12), out


def leaves(params) -> List[torch.Tensor]:
    """The tensors of a params dict in a fixed order: keys, then layers."""
    out = []
    for v in params.values():
        out += list(v) if isinstance(v, (list, tuple)) else [v]
    return out


def clone(params, requires_grad=False):
    return {k: [w.detach().clone().requires_grad_(requires_grad) for w in v] if isinstance(v, list)
            else v.detach().clone().requires_grad_(requires_grad) for k, v in params.items()}


class Adam:
    """torch-ngp's optimizer: Adam (0.9, 0.99), eps 1e-15, learning rate
    lr * 0.1^(k / iters) at update k, bias-corrected."""

    def __init__(self, params, lr: float, iters: int, moments=None, k: int = 0):
        """``moments`` (first, second: lists of leaves) and ``k`` updates
        already made continue an optimizer's state; else it starts at zero."""
        self.params, self.lr, self.iters, self.k = params, lr, iters, k
        if moments is None:
            moments = ([torch.zeros_like(p) for p in leaves(params)], [torch.zeros_like(p) for p in leaves(params)])
        self.m = [m.detach().clone() for m in moments[0]]
        self.v = [v.detach().clone() for v in moments[1]]

    @torch.no_grad()
    def step(self):
        lr = self.lr * 0.1 ** min(self.k / self.iters, 1.0)
        self.k += 1
        bc1, bc2 = 1.0 - 0.9**self.k, 1.0 - 0.99**self.k
        for p, m, v in zip(leaves(self.params), self.m, self.v):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            m.mul_(0.9).add_(g, alpha=0.1)
            v.mul_(0.99).addcmul_(g, g, value=0.01)
            p.sub_(lr / bc1 * m / (v.sqrt() / math.sqrt(bc2) + 1e-15))
            p.grad = None


def batch_of(scene: Dict, view: int, inds: torch.Tensor, device):
    """A training batch of view ``view`` at flat pixel indices ``inds``."""
    o, d = camera_rays(scene["poses"][view].to(device), scene["intrinsics"], scene["H"], scene["W"], inds)
    return {
        "rays_o": o, "rays_d": d,
        "pixels": scene["pixels"][view].reshape(-1, 4)[inds].to(device).float(),
        "ray_mask": scene["masks"][view].reshape(-1)[inds].to(device),
        "obj_feat": scene["feats"][view].to(device),
    }
