"""Baked real-time rendering: dense voxel bake + shear-warp compositing.

Twin of focnerf_tpu/render/baked.py. A trained object is baked once into a
dense RGBA voxel grid (``bake_field``), and frames are rendered by the
shear-warp factorization (Lacroute & Levoy):

  1. pick the volume axis most aligned with the view direction (on the host);
  2. resample every slice onto a common intermediate plane through a
     per-slice scale + translation (perspective through the eye): a separable
     resampling, two batched matrix products per block of slices with hat
     (linear-interpolation) matrices;
  3. composite the slices front to back in log space (per-pixel step length
     from the ray obliquity, exact for the pinhole);
  4. warp the intermediate image to screen pixels (one bilinear gather).

Composition is a bake-time merge by max density (``merge_volumes``), so a
frame costs the same whatever the object count; rigid edits shift or rotate
one object's volume before the merge.

Precision follows the device, as JAX's follows the backend: on the CPU the
resampling is fp32; on the card the volume and the hat matrices are rounded
to bf16 and multiplied as fp32 products (the port's convention for every
product, ``resolve_device``), and the first product's result is rounded to
bf16 before the second. A uint8-resident ``QuantizedVolume`` dequantizes per
block inside the fold, in bf16 on the card and fp32 on the CPU.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.utils.checkpoint

from focnerf_tpu_torch.ops.hashgrid import _device_tuple


class BakedVolume(NamedTuple):
    """Dense bake. ``rgba`` is [R, R, R, P+1]: P payload channels + raw sigma
    last, axes (x, y, z), world [-b, b]. P == 3 is plain rgb (sh_deg == 0);
    with sh_deg = n the payload is 3*n^2 SH coefficients (layout [l, rgb])
    contracted against the per-ray basis at render time."""

    rgba: torch.Tensor
    bound: float
    sh_deg: int = 0


class QuantizedVolume(NamedTuple):
    """uint8-resident bake: ``q`` stays uint8 on the device and dequantizes
    inside the compositing fold. Payload channels are affine
    (q/255 * scale + lo); the sigma channel stores sqrt(sigma)/sqrt_max with
    its sqrt_max in ``scales[-1]`` and ``los[-1] == 0``."""

    q: torch.Tensor  # [R, R, R, P+1] uint8
    scales: torch.Tensor  # [P+1] float32
    los: torch.Tensor  # [P+1] float32
    bound: float
    sh_deg: int = 0


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def quantize_volume(vol) -> QuantizedVolume:
    """In-memory uint8 quantization (the math of save_volume(quantize=True),
    in numpy: ``np.round`` takes halves to even); idempotent."""
    if isinstance(vol, QuantizedVolume):
        return vol
    device = vol.rgba.device
    rgba = _host(vol.rgba).astype(np.float32)
    payload, sigma = rgba[..., :-1], rgba[..., -1:]
    lo = payload.min(axis=(0, 1, 2))
    hi = payload.max(axis=(0, 1, 2))
    scale = np.where(hi > lo, hi - lo, 1.0).astype(np.float32)
    qp = np.clip(np.round((payload - lo) / scale * 255.0), 0, 255)
    s_max = float(max(np.sqrt(sigma.max()), 1e-8))
    qs = np.clip(np.round(np.sqrt(np.maximum(sigma, 0.0)) / s_max * 255.0), 0, 255)
    return QuantizedVolume(
        q=torch.from_numpy(np.concatenate([qp, qs], -1).astype(np.uint8)).to(device),
        scales=torch.from_numpy(np.concatenate([scale, [s_max]]).astype(np.float32)).to(device),
        los=torch.from_numpy(np.concatenate([lo, [0.0]]).astype(np.float32)).to(device),
        bound=vol.bound,
        sh_deg=vol.sh_deg,
    )


def dequantize_volume(qvol: QuantizedVolume) -> BakedVolume:
    """Dense fp32 view of a quantized volume (for the merge and edit paths)."""
    y = qvol.q.float() / 255.0 * qvol.scales + qvol.los
    y[..., -1] = y[..., -1] ** 2  # sigma stored in sqrt space
    return BakedVolume(rgba=y, bound=qvol.bound, sh_deg=qvol.sh_deg)


# --------------------------------------------------------------------- bake
def _cell_centers(R: int, b: float, device) -> torch.Tensor:
    return (torch.arange(R, dtype=torch.float32, device=device) + 0.5) / R * (2 * b) - b


def _sh_projection(sh_degree: int, n_dirs: int):
    """(Fibonacci-sphere directions [D, 3] float32, least-squares projection
    [L, D] onto the first sh_degree^2 SH basis functions), numpy."""
    from focnerf_tpu_torch.ops.sh import sh_encode

    i = np.arange(n_dirs, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n_dirs)
    theta = np.pi * (1.0 + 5.0**0.5) * i
    dirs = np.stack(
        [np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi), np.cos(phi)], -1
    ).astype(np.float32)
    Y = sh_encode(torch.from_numpy(dirs), sh_degree).numpy()  # [D, L]
    return dirs, np.linalg.pinv(Y)


@torch.no_grad()
def bake_field(
    params,
    cfg,
    *,
    resolution: int = 256,
    obj_feat=None,
    occ_bits: Optional[torch.Tensor] = None,
    grid_size: int = 128,
    chunk: int = 2**16,
    sh_degree: int = 0,
    n_dirs: int = 48,
) -> BakedVolume:
    """Evaluate a trained field on a dense voxel grid (on the params' device).

    The field is evaluated in chunks of ``chunk`` voxel centres with the
    exact encode (the values of JAX's "gather" forward mode). ``occ_bits``
    ([CAS, grid_size^3] or [grid_size^3], bool) zeroes density outside the
    trained occupancy, each voxel read in the cascade that owns its position.
    ``sh_degree`` > 0 bakes view-dependent colour: the colour net is sampled
    at ``n_dirs`` Fibonacci directions per voxel and projected by least
    squares onto sh_degree^2 SH coefficients per channel; 0 bakes the
    colour seen along the outward radial direction.
    """
    from focnerf_tpu_torch.models.nerf import color_fn, density_fn, encode_objfeat

    device = params["grid"].device
    R = resolution
    b = float(cfg.bound)
    centers = _cell_centers(R, b, device)
    X, Y, Z = torch.meshgrid(centers, centers, centers, indexing="ij")
    pts = torch.stack([X, Y, Z], -1).reshape(-1, 3)  # [R^3, 3] x-major

    objfeat_enc = None
    if cfg.use_objfeat:
        if obj_feat is None:
            raise ValueError("cfg.use_objfeat=True requires obj_feat")
        obj_feat = torch.as_tensor(obj_feat, dtype=torch.float32, device=device)
        objfeat_enc = encode_objfeat(params, cfg, obj_feat)

    if sh_degree > 0:
        dirs_np, proj_np = _sh_projection(sh_degree, n_dirs)
        dirs = torch.from_numpy(dirs_np).to(device)
        proj = torch.from_numpy(proj_np).to(device)

        def eval_chunk(p):
            sigma, geo = density_fn(params, cfg, p)
            n_pts = p.shape[0]
            d_all = dirs[:, None, :].expand(n_dirs, n_pts, 3)
            geo_all = geo[None].expand((n_dirs,) + geo.shape)
            rgb = color_fn(params, cfg, d_all, geo_all, objfeat_enc)  # [D, n, 3]
            coef = torch.einsum("ld,dnc->nlc", proj, rgb)  # [n, L, 3]
            return torch.cat([coef.reshape(n_pts, -1), sigma[..., None]], -1)
    else:

        def eval_chunk(p):
            sigma, geo = density_fn(params, cfg, p)
            d = p / torch.clamp(torch.linalg.norm(p, dim=-1, keepdim=True), min=1e-6)
            rgb = color_fn(params, cfg, d, geo, objfeat_enc)
            return torch.cat([rgb, sigma[..., None]], -1)

    rgba = torch.cat([eval_chunk(pts[i : i + chunk]) for i in range(0, pts.shape[0], chunk)])

    if occ_bits is not None:
        occ2 = occ_bits.reshape(-1, grid_size**3)  # [CAS, H^3]
        cas = occ2.shape[0]
        # cascade c covers [-2^c, 2^c]: read each voxel in the cascade that
        # owns its position (the marcher's mip level with dt -> 0)
        _, e_pos = torch.frexp(pts.abs().amax(-1))
        level = torch.clamp(e_pos, 0, cas - 1).long()
        mip_bound = torch.clamp(torch.exp2(level.float()), max=b)
        cell = torch.clamp(
            (0.5 * (pts / mip_bound[:, None] + 1.0) * grid_size).to(torch.int32), 0, grid_size - 1
        ).long()
        lin = (cell[:, 0] * grid_size + cell[:, 1]) * grid_size + cell[:, 2]
        occ_r = occ2[level, lin]
        rgba[:, -1] = torch.where(occ_r, rgba[:, -1], torch.zeros_like(rgba[:, -1]))

    return BakedVolume(rgba=rgba.reshape(R, R, R, rgba.shape[-1]), bound=b, sh_deg=sh_degree)


# ------------------------------------------------------------------ storage
def save_volume(path: str, vol, quantize: bool = False) -> None:
    """Write a baked volume as JAX's save_volume does (the same npz keys and
    dtypes, so either package reads the other's files): float16 ``rgba`` by
    default; with ``quantize`` uint8 payload and sqrt-space sigma with their
    per-channel affine scales. A QuantizedVolume is written as it is with
    ``quantize``, dequantized first otherwise."""
    if isinstance(vol, QuantizedVolume) and not quantize:
        vol = dequantize_volume(vol)
    if not quantize:
        np.savez_compressed(
            path,
            rgba=_host(vol.rgba).astype(np.float16),
            bound=np.float32(vol.bound),
            sh_deg=np.int32(vol.sh_deg),
        )
        return
    qvol = quantize_volume(vol)
    q = _host(qvol.q)
    np.savez_compressed(
        path,
        q_payload=q[..., :-1],
        q_sigma=q[..., -1],
        lo=_host(qvol.los)[:-1],
        scale=_host(qvol.scales)[:-1],
        sigma_sqrt_max=np.float32(_host(qvol.scales)[-1]),
        bound=np.float32(vol.bound),
        sh_deg=np.int32(vol.sh_deg),
    )


def load_volume(path: str, resident: bool = False, device=None):
    """Load a baked volume (fp16 or uint8, autodetected) onto ``device``
    (None: ``cuda``). ``resident`` returns a QuantizedVolume (an fp16 file is
    quantized in memory first); otherwise a dense fp32 BakedVolume."""
    from focnerf_tpu_torch import resolve_device

    device = resolve_device(device)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    with np.load(path) as z:
        bound = float(z["bound"])
        sh_deg = int(z["sh_deg"]) if "sh_deg" in z else 0
        if "q_payload" in z:
            if resident:
                return QuantizedVolume(
                    q=to(np.concatenate([z["q_payload"], z["q_sigma"][..., None]], -1)),
                    scales=to(np.concatenate([z["scale"], [float(z["sigma_sqrt_max"])]]).astype(np.float32)),
                    los=to(np.concatenate([z["lo"], [0.0]]).astype(np.float32)),
                    bound=bound,
                    sh_deg=sh_deg,
                )
            payload = z["q_payload"].astype(np.float32) / 255.0 * z["scale"] + z["lo"]
            s = z["q_sigma"].astype(np.float32) / 255.0 * float(z["sigma_sqrt_max"])
            rgba = np.concatenate([payload, (s * s)[..., None]], -1)
            return BakedVolume(rgba=to(rgba), bound=bound, sh_deg=sh_deg)
        vol = BakedVolume(rgba=to(z["rgba"].astype(np.float32)), bound=bound, sh_deg=sh_deg)
        return quantize_volume(vol) if resident else vol


# -------------------------------------------------------------------- edits
def shift_volume(vol: BakedVolume, offset_world: Sequence[float]) -> BakedVolume:
    """Translate a baked object by whole voxels (``round`` takes halves to
    even): the object appears at field position + offset_world, and the
    voxels that wrap around are emptied. A compose offset (the field queried
    at x + offset) places the object at -offset, so its baked equivalent is
    ``shift_volume(vol, -offset)``."""
    R = vol.rgba.shape[0]
    vox = R / (2.0 * vol.bound)
    rgba = vol.rgba
    for ax in range(3):
        s = int(round(float(offset_world[ax]) * vox))
        if s == 0:
            continue
        rgba = torch.roll(rgba, s, dims=ax)
        band = [slice(None)] * 4
        band[ax] = slice(0, s) if s > 0 else slice(max(R + s, 0), R)
        rgba[tuple(band)] = 0.0
    return BakedVolume(rgba=rgba, bound=vol.bound, sh_deg=vol.sh_deg)


def rotate_volume(
    vol: BakedVolume,
    axis: int,
    degrees: float,
    center: Sequence[float] = (0.0, 0.0, 0.0),
) -> BakedVolume:
    """Rotate a baked object by +degrees, right-handed, about ``axis``
    through ``center`` (world units; the world origin by default, as JAX).

    Multiples of 90 degrees about the origin are lossless swaps and flips;
    other angles resample bilinearly in the plane of rotation, each source
    corner outside the cube reading as empty (map_coordinates order 1,
    mode "constant").
    """
    R = vol.rgba.shape[0]
    b = float(vol.bound)
    # the right-handed in-plane pair about +axis is the cyclic one: about +y
    # it is (z, x); the ascending (x, z) would negate the rotation
    u_ax, v_ax = ((1, 2), (2, 0), (0, 1))[axis]
    deg = float(degrees) % 360.0

    if deg % 90.0 == 0.0 and all(abs(c) < 1e-9 for c in center):
        rgba = vol.rgba
        for _ in range(int(deg // 90) % 4):  # +90 deg: (u, v) -> (-v, u)
            rgba = torch.flip(torch.transpose(rgba, u_ax, v_ax), (u_ax,))
        return BakedVolume(rgba=rgba.contiguous(), bound=vol.bound, sh_deg=vol.sh_deg)

    th = np.deg2rad(deg)
    c_, s_ = float(np.cos(th)), float(np.sin(th))
    centers = _cell_centers(R, b, vol.rgba.device)
    u = centers[:, None] - center[u_ax]
    v = centers[None, :] - center[v_ax]
    su = c_ * u + s_ * v + center[u_ax]  # inverse rotation R(-th)(u, v)
    sv = -s_ * u + c_ * v + center[v_ax]
    cu = (su + b) / (2 * b) * R - 0.5
    cv = (sv + b) / (2 * b) * R - 0.5
    # the two taps and weights of each output pixel, per in-plane axis
    taps = []
    for c in (cu, cv):
        lower = torch.floor(c)
        w_hi = c - lower
        i = lower.to(torch.int64)
        taps.append(((i, 1 - w_hi), (i + 1, w_hi)))

    # the invariant axis first: each slice resamples from itself, a block
    # of slices at a time (transients O(block * R^2), not O(R^3))
    perm = (axis, u_ax, v_ax)
    V = vol.rgba.permute(perm + (3,))
    out = []
    for s0 in range(0, R, 32):
        Vb = V[s0 : s0 + 32]
        acc = None
        for iu, wu in taps[0]:
            for iv, wv in taps[1]:
                ok = (iu >= 0) & (iu < R) & (iv >= 0) & (iv < R)
                val = Vb[:, iu.clamp(0, R - 1), iv.clamp(0, R - 1)]  # [K, R, R, CH]
                term = (wu * wv)[None, :, :, None] * torch.where(ok[None, :, :, None], val, 0.0)
                acc = term if acc is None else acc + term
        out.append(acc)
    V = torch.cat(out, 0)
    inv = tuple(int(i) for i in np.argsort(perm))
    return BakedVolume(rgba=V.permute(inv + (3,)).contiguous(), bound=vol.bound, sh_deg=vol.sh_deg)


def merge_volumes(vols: List[BakedVolume]) -> BakedVolume:
    """Max-density fusion of per-object volumes: a later object takes a voxel
    only where its sigma is strictly greater (the first wins ties)."""
    if not vols:
        raise ValueError("merge_volumes needs at least one volume")
    out = vols[0].rgba
    for v in vols[1:]:
        if v.rgba.shape != out.shape or v.bound != vols[0].bound or v.sh_deg != vols[0].sh_deg:
            raise ValueError("merge_volumes: volumes differ in shape, bound or sh_deg")
        out = torch.where(v.rgba[..., -1:] > out[..., -1:], v.rgba, out)
    return BakedVolume(rgba=out, bound=vols[0].bound, sh_deg=vols[0].sh_deg)


# ------------------------------------------------------------------- render
def _device_dtype(t: torch.Tensor) -> torch.dtype:
    """The resampling dtype of the device ``t`` lives on."""
    return torch.float32 if t.device.type == "cpu" else torch.bfloat16


def _hat(x):
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _grid_geometry(e_z, e_y, e_x, b: float, ri: int):
    """Intermediate-plane pixel grid: the volume footprint on z'=0 seen from
    the (permuted-coordinates) eye, fp32 0-d tensors. Returns (gy [ri], gx
    [ri], ymin, xmin, dy_i, dx_i)."""
    corners = _device_tuple((-float(b), float(b)), torch.float32, e_z.device)  # no host copy: a CUDA graph holds it
    s_c = e_z / (e_z - corners)  # scale for the two extreme slices [2]
    uy = e_y + (corners[None, :] - e_y) * s_c[:, None]  # [2 slices, 2 corners]
    ux = e_x + (corners[None, :] - e_x) * s_c[:, None]
    ymin, ymax = uy.min(), uy.max()
    xmin, xmax = ux.min(), ux.max()
    dy_i = (ymax - ymin) / ri
    dx_i = (xmax - xmin) / ri
    grid = torch.arange(ri, dtype=torch.float32, device=e_z.device) + 0.5
    return ymin + grid * dy_i, xmin + grid * dx_i, ymin, xmin, dy_i, dx_i


def _eye(pose: torch.Tensor, axis: int, flip: bool):
    """(e_z, e_y, e_x, the other two axes): the eye in the permuted frame,
    with e_z negated when the slices are flipped."""
    others = [a for a in range(3) if a != axis]
    e = pose[:3, 3]
    e_z = -e[axis] if flip else e[axis]
    return e_z, e[others[0]], e[others[1]], others


def warp_gt_to_intermediate(gt, pose, intr, bound: float, *, axis: int, flip: bool, ri: int):
    """Resample a GT image [H, W, 3] onto the shear-warp intermediate plane.

    Each intermediate pixel is one primary ray (eye -> plane point); its
    colour is the GT bilinearly sampled where that ray crosses the screen.
    Returns (warped GT [ri, ri, 3], mask [ri, ri]: 1 where the ray lands
    inside the image in front of the camera)."""
    device = gt.device
    pose = torch.as_tensor(np.asarray(_host(pose), np.float32), device=device)
    intr = torch.as_tensor(np.asarray(_host(intr), np.float32), device=device)
    H, W = gt.shape[0], gt.shape[1]
    e_z, e_y, e_x, others = _eye(pose, axis, flip)
    gy, gx, *_ = _grid_geometry(e_z, e_y, e_x, bound, ri)

    # the plane z'=0 is the world plane [axis]=0 whatever the flip
    p_world = torch.zeros((ri, ri, 3), dtype=torch.float32, device=device)
    p_world[..., others[0]] = gy[:, None]
    p_world[..., others[1]] = gx[None, :]

    rel = p_world - pose[:3, 3]
    p_cam = rel @ pose[:3, :3]  # R^T @ rel per pixel
    z = p_cam[..., 2]
    zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    u = p_cam[..., 0] / zs * fx + cx - 0.5  # column (W axis)
    v = p_cam[..., 1] / zs * fy + cy - 0.5  # row (H axis)

    mask = (z > 0) & (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    y0 = torch.clamp(torch.floor(v).to(torch.int64), 0, H - 2)
    x0 = torch.clamp(torch.floor(u).to(torch.int64), 0, W - 2)
    wy = torch.clamp(v - y0, 0.0, 1.0)[..., None]
    wx = torch.clamp(u - x0, 0.0, 1.0)[..., None]
    wgt = (
        gt[y0, x0] * (1 - wy) * (1 - wx)
        + gt[y0, x0 + 1] * (1 - wy) * wx
        + gt[y0 + 1, x0] * wy * (1 - wx)
        + gt[y0 + 1, x0 + 1] * wy * wx
    )
    return wgt, mask.float()


def _hat_matrices(zb, e_z, e_y, e_x, gy, gx, b: float, iota, dtype):
    """The resampling matrices of a block of slices at z' = zb [K]: for each
    slice, the hat weights from its R voxel rows (columns) to the ri
    intermediate rows (columns), My, Mx [K, R, ri] in ``dtype``."""
    R = iota.shape[0]
    s_k = e_z / (e_z - zb)  # [K]
    # source world coordinates feeding each intermediate pixel
    ys = e_y + (gy[None, :] - e_y) / s_k[:, None]  # [K, ri]
    xs = e_x + (gx[None, :] - e_x) / s_k[:, None]
    py = (ys + b) / (2 * b) * R - 0.5  # voxel coordinates
    px = (xs + b) / (2 * b) * R - 0.5
    My = _hat(py[:, None, :] - iota[None, :, None]).to(dtype)
    Mx = _hat(px[:, None, :] - iota[None, :, None]).to(dtype)
    return My, Mx


def _resample(Vb, My, Mx, dtype):
    """The two resampling products of a block: Vb [K, Ry, Rx, CH] (values
    already in ``dtype``) with the hat matrices My [K, Ry, ri] and Mx
    [K, Rx, ri] -> slices [K, ri(y), CH, ri(x)] fp32. Operands are fp32
    copies of ``dtype`` values; the first result is rounded to ``dtype``."""
    K, Ry, Rx, CH = Vb.shape
    ri = My.shape[-1]
    tmp = torch.bmm(My.transpose(1, 2).float(), Vb.reshape(K, Ry, Rx * CH).float())  # [K, ri, Rx*CH]
    tmp = tmp.to(dtype).float().view(K, ri, Rx, CH).transpose(2, 3).reshape(K, ri * CH, Rx)
    return torch.bmm(tmp, Mx.float()).view(K, ri, CH, ri)


def _accumulate(sl, zb, e_z, dt, density_scale: float, od, C, D):
    """Front-to-back fold of one block of resampled slices sl [K, ri, CH, ri]
    into (od [ri, ri], C [ri, CH-1, ri], D [ri, ri] or None). Transmittance is
    carried as optical depth; the exclusive prefix within the block is a
    shifted cumsum, never acc - s (exp(inf - inf) is NaN on a sigma spike)."""
    sigma = torch.clamp(sl[:, :, -1, :], min=0.0) * density_scale
    s = sigma * dt[None]  # per-sample optical depth [K, ri, ri]
    alpha = 1.0 - torch.exp(-s)
    acc_excl = torch.cat([torch.zeros_like(s[:1]), torch.cumsum(s[:-1], 0)], 0)
    w = torch.exp(-(acc_excl + od[None])) * alpha
    C = C + torch.einsum("kyx,kycx->ycx", w, sl[:, :, :-1, :])
    if D is not None:
        D = D + torch.einsum("kyx,k->yx", w, e_z - zb)
    od = od + acc_excl[-1] + s[-1]
    return od, C, D


def _fold_blocks(
    V_f2b,  # [n_blocks, K, Ry, Rx, CH] slice blocks, front-to-back
    z_f2b,  # [n_blocks, K] slice z' coordinates (same order)
    e_z,
    e_y,
    e_x,
    gy,  # [ri] intermediate-grid y centres
    gx,  # [ri]
    dt,  # [ri, ri] per-pixel step length
    b: float,
    R: int,  # full spatial resolution of the slices (y/x extents)
    ri: int,
    *,
    density_scale: float,
    carry=None,  # optional (od, C, D) to continue from (identity if None)
    with_depth: bool = True,
    return_od: bool = False,
    dequant=None,
    compute_dtype=None,
    remat: bool = False,
):
    """Resample + front-to-back composite a sequence of slice blocks.

    ``carry`` continues a fold (od [ri, ri], C [ri, ri, CH-1], D [ri, ri]);
    ``with_depth`` False drops the depth accumulator; ``return_od`` returns
    the optical depth instead of T = exp(-od); ``dequant`` maps a raw block
    to values inside the loop (uint8-resident volumes). The resampling dtype
    is the blocks' own, or with ``dequant`` ``compute_dtype`` (None: fp32 on
    the CPU, bf16 on the card). Differentiable through autograd; ``remat``
    checkpoints each block's resample and fold (JAX's ``jax.checkpoint`` of
    the scan body): autograd keeps only the block's inputs and recomputes
    the rest in the backward, the same values in the same order.

    Returns (T or od [ri, ri], C [ri, ri, CH-1] premultiplied, D [ri, ri] or
    None)."""
    CH = V_f2b.shape[-1]
    dtype = V_f2b.dtype
    if dequant is not None:
        dtype = compute_dtype or _device_dtype(V_f2b)
    device = V_f2b.device
    iota = torch.arange(R, dtype=torch.float32, device=device)
    if carry is None:
        od = torch.zeros((ri, ri), dtype=torch.float32, device=device)
        C = torch.zeros((ri, CH - 1, ri), dtype=torch.float32, device=device)
        D = torch.zeros((ri, ri), dtype=torch.float32, device=device) if with_depth else None
    else:
        od, C = carry[0], carry[1].permute(0, 2, 1)
        D = carry[2] if with_depth else None

    def block(Vb, zb, od, C, D):
        if dequant is not None:
            Vb = dequant(Vb).to(dtype)
        My, Mx = _hat_matrices(zb, e_z, e_y, e_x, gy, gx, b, iota, dtype)
        sl = _resample(Vb, My, Mx, dtype)
        return _accumulate(sl, zb, e_z, dt, density_scale, od, C, D)

    for Vb, zb in zip(V_f2b, z_f2b):
        if remat:
            # the fold draws no random numbers: no RNG state to keep (its
            # read would not hold inside a CUDA graph capture)
            od, C, D = torch.utils.checkpoint.checkpoint(block, Vb, zb, od, C, D, use_reentrant=False,
                                                         preserve_rng_state=False)
        else:
            od, C, D = block(Vb, zb, od, C, D)

    first = od if return_od else torch.exp(-od)
    return first, C.permute(0, 2, 1), D


def sh_contract_plane(C, e_z, e_y, e_x, gy, gx, *, axis, flip, ri, sh_deg):
    """Contract a composited SH payload [ri, ri, L*3] with one basis per
    intermediate pixel (each pixel is one primary ray through the eye):
    rgb = sum_l Y_l(dir) * C[..., l, :], clipped to [0, 1]. ``e_z`` already
    carries the flip's negation."""
    from focnerf_tpu_torch.ops.sh import sh_encode

    others = [a for a in range(3) if a != axis]
    d_world = torch.zeros((ri, ri, 3), dtype=torch.float32, device=C.device)
    d_world[..., axis] = -e_z * (-1.0 if flip else 1.0)
    d_world[..., others[0]] = (gy - e_y)[:, None]
    d_world[..., others[1]] = (gx - e_x)[None, :]
    d_world = d_world / torch.clamp(torch.linalg.norm(d_world, dim=-1, keepdim=True), min=1e-9)
    L = sh_deg * sh_deg
    Y = sh_encode(d_world, sh_deg)  # [ri, ri, L]
    C = torch.einsum("ijl,ijlc->ijc", Y, C.reshape(ri, ri, L, 3))
    return torch.clamp(C, 0.0, 1.0)


def _dequant(Vb, s_b, l_b, dtype):
    """A uint8 block -> values in ``dtype`` (q * scale/255 + lo, the sigma
    channel squared back from sqrt space)."""
    y = Vb.to(dtype) * s_b + l_b
    y[..., -1] = y[..., -1] ** 2
    return y


def _relayout(rgba, axis: int, flip: bool, dtype, block: int):
    """The volume with the principal axis leading and its slices front to
    back (nearest the eye first), cast to ``dtype`` (None keeps it), in
    blocks [R // block, block, R, R, CH]."""
    R, CH = rgba.shape[0], rgba.shape[-1]
    others = [a for a in range(3) if a != axis]
    V = rgba.permute(axis, others[0], others[1], 3)
    if dtype is not None:
        V = V.to(dtype)
    if not flip:  # the eye is on the +z' side: the last slice is nearest
        V = torch.flip(V, (0,))
    return V.contiguous().view(R // block, block, R, R, CH)


def _composite_core(
    rgba,  # [R, R, R, CH] axes (x, y, z)
    bound: float,
    pose,  # [4, 4] c2w tensor on rgba's device
    *,
    axis: int,
    flip: bool,
    ri: int,
    density_scale: float,
    sh_deg: int = 0,
    block: int = 32,
    quant=None,  # (scales [CH], los [CH]) when rgba is uint8-resident
    compute_dtype=None,  # None: fp32 on the CPU, bf16 on the card
    remat: bool = False,
    with_depth: bool = True,
):
    """Slice-resample + front-to-back composite onto the intermediate plane.

    Returns (C [ri, ri, 3] premultiplied colour, T [ri, ri] transmittance,
    D [ri, ri] depth along z' (None without ``with_depth``: training never
    reads it), (ymin, xmin, dy_i, dx_i) grid geometry)."""
    R = rgba.shape[0]
    b = bound
    dtype = compute_dtype or _device_dtype(rgba)
    dequant = None
    if quant is not None:
        scales, los = quant
        s_b = (scales / 255.0).to(dtype)
        l_b = los.to(dtype)
        dequant = lambda Vb: _dequant(Vb, s_b, l_b, dtype)  # noqa: E731

    K = min(block, R)
    if R % K:
        raise ValueError(f"volume resolution {R} is not a multiple of the block {K}")
    # uint8 stays uint8 through the relayout; fp32 volumes on the CPU stay fp32
    cast = None if quant is not None or dtype == rgba.dtype else dtype
    V_f2b = _relayout(rgba, axis, flip, cast, K)
    e_z, e_y, e_x, _ = _eye(pose, axis, flip)
    centers = _cell_centers(R, b, rgba.device)  # z'_k
    z_f2b = torch.flip(centers, (0,)).view(R // K, K)
    dz = 2.0 * b / R

    gy, gx, ymin, xmin, dy_i, dx_i = _grid_geometry(e_z, e_y, e_x, b, ri)
    # per-pixel ray obliquity: dt = dz * |d| / |d_z|, d through the eye
    ddy = gy[:, None] - e_y
    ddx = gx[None, :] - e_x
    dlen = torch.sqrt(ddy**2 + ddx**2 + e_z**2)
    dt = dz * dlen / torch.clamp(e_z.abs(), min=1e-6)

    T, C, D = _fold_blocks(
        V_f2b, z_f2b, e_z, e_y, e_x, gy, gx, dt, b, R, ri,
        density_scale=density_scale, dequant=dequant, compute_dtype=dtype, remat=remat,
        with_depth=with_depth,
    )
    if sh_deg > 0:
        C = sh_contract_plane(C, e_z, e_y, e_x, gy, gx, axis=axis, flip=flip, ri=ri, sh_deg=sh_deg)
    return C, T, D, (ymin, xmin, dy_i, dx_i)


def _warp(C, T, D, geometry, pose, intr, *, axis, flip, H, W, ri, bg_color):
    """Final warp: screen pixel -> plane z'=0 -> bilinear sample of the
    intermediate (C, T, D). Returns (image [H, W, 3], depth, alpha)."""
    ymin, xmin, dy_i, dx_i = geometry
    e_z, e_y, e_x, others = _eye(pose, axis, flip)
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    jj, ii = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=C.device),
        torch.arange(W, dtype=torch.float32, device=C.device),
        indexing="ij",
    )
    dirs = torch.stack([(ii + 0.5 - cx) / fx, (jj + 0.5 - cy) / fy, torch.ones_like(ii)], -1)
    d_world = dirs @ pose[:3, :3].T
    d_z = d_world[..., axis] * (-1.0 if flip else 1.0)
    d_y = d_world[..., others[0]]
    d_x = d_world[..., others[1]]
    t_pl = -e_z / torch.where(d_z.abs() < 1e-9, torch.full_like(d_z, 1e-9), d_z)
    hit = t_pl > 0
    fy_i = (e_y + d_y * t_pl - ymin) / dy_i - 0.5  # intermediate pixel coordinates
    fx_i = (e_x + d_x * t_pl - xmin) / dx_i - 0.5

    buf = torch.cat([C, T[..., None], D[..., None]], -1)  # [ri, ri, 5]
    y0 = torch.clamp(torch.floor(fy_i).to(torch.int64), 0, ri - 2)
    x0 = torch.clamp(torch.floor(fx_i).to(torch.int64), 0, ri - 2)
    wy = torch.clamp(fy_i - y0, 0.0, 1.0)[..., None]
    wx = torch.clamp(fx_i - x0, 0.0, 1.0)[..., None]
    smp = (
        buf[y0, x0] * (1 - wy) * (1 - wx)
        + buf[y0, x0 + 1] * (1 - wy) * wx
        + buf[y0 + 1, x0] * wy * (1 - wx)
        + buf[y0 + 1, x0 + 1] * wy * wx
    )  # [H, W, 5]
    rgb_s, T_s, D_s = smp[..., :3], smp[..., 3], smp[..., 4]
    rgb_s = torch.where(hit[..., None], rgb_s, torch.zeros_like(rgb_s))
    T_s = torch.clamp(torch.where(hit, T_s, torch.ones_like(T_s)), 0.0, 1.0)
    image = rgb_s + T_s[..., None] * bg_color
    depth = torch.where(hit, D_s, torch.zeros_like(D_s))
    return image, depth, 1.0 - T_s


def _render_core(
    rgba,
    bound: float,
    pose,  # [4, 4] c2w tensor on rgba's device
    intr,  # [4] fx, fy, cx, cy tensor
    *,
    axis: int,
    flip: bool,
    H: int,
    W: int,
    ri: int,
    bg_color: float,
    density_scale: float,
    sh_deg: int = 0,
    quant=None,
    compute_dtype=None,
    remat: bool = False,
):
    C, T, D, geometry = _composite_core(
        rgba, bound, pose, axis=axis, flip=flip, ri=ri, density_scale=density_scale,
        sh_deg=sh_deg, quant=quant, compute_dtype=compute_dtype, remat=remat,
    )
    return _warp(C, T, D, geometry, pose, intr, axis=axis, flip=flip, H=H, W=W, ri=ri,
                 bg_color=bg_color)


def view_axis(pose, bound: float):
    """(axis, flip) of a view: the axis most aligned with the view
    direction, or, when the eye sits inside the slab along it, the axis the
    eye is farthest out on; ``flip`` when the eye is on that axis's negative
    side. Raises ValueError when the eye is inside the cube."""
    pose_np = np.asarray(_host(pose), np.float32)
    fwd = pose_np[:3, :3] @ np.array([0.0, 0.0, 1.0], np.float32)
    axis = int(np.argmax(np.abs(fwd)))
    eye = pose_np[:3, 3]
    # shear-warp needs the eye strictly outside the slab along the axis
    # (every s_k = e_z / (e_z - z_k) positive)
    if abs(eye[axis]) <= bound:
        axis = int(np.argmax(np.abs(eye)))
    if abs(eye[axis]) <= bound:
        raise ValueError(
            f"render_baked: eye {eye.tolist()} is inside the volume cube (bound {bound}); "
            "shear-warp needs an exterior camera — move the eye out or use the per-sample "
            "render path"
        )
    return axis, bool(pose_np[axis, 3] < 0)


def render_baked(
    vol,
    pose,
    intrinsics,
    H: int,
    W: int,
    *,
    bg_color: float = 1.0,
    intermediate_scale: int = 2,
    density_scale: float = 1.0,
):
    """Shear-warp render of a baked volume -> (image [H, W, 3], depth [H, W],
    alpha [H, W]) on the volume's device. ``pose``/``intrinsics`` follow
    core.rays.get_rays. ``vol`` may be a BakedVolume or a QuantizedVolume
    (uint8-resident, dequantized inside the fold). The axis and flip are
    chosen on the host (``view_axis``)."""
    quant = None
    if isinstance(vol, QuantizedVolume):
        quant = (vol.scales, vol.los)
        vol = BakedVolume(rgba=vol.q, bound=vol.bound, sh_deg=vol.sh_deg)
    b = float(vol.bound)
    axis, flip = view_axis(pose, b)
    device = vol.rgba.device
    pose_t = torch.as_tensor(np.asarray(_host(pose), np.float32), device=device)
    intr_t = torch.as_tensor(np.asarray(_host(intrinsics), np.float32), device=device)
    return _render_core(
        vol.rgba, b, pose_t, intr_t, axis=axis, flip=flip, H=H, W=W,
        ri=int(vol.rgba.shape[0] * intermediate_scale), bg_color=bg_color,
        density_scale=density_scale, sh_deg=int(vol.sh_deg), quant=quant,
        compute_dtype=_device_dtype(vol.rgba),
    )
