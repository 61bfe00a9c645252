"""Occupancy-aware ray marching with fixed shapes.

Twin of focnerf_tpu/ops/marching.py (``candidate_ts``, ``_mip_level``,
``march_rays``, ``march_rays_skip``). The CUDA marcher's t-values are a
prefix-subset of the no-skip recurrence ``t += clamp(t * dt_gamma, dt_min,
dt_max)``:

  - ``march_rays``: the closed form gives the whole candidate ladder
    [N, max_steps]; each candidate looks up the mip-level bitfield, and a
    stable sort moves the first ``slab`` occupied candidates of each ray to
    the front;
  - ``march_rays_skip``: a sphere-trace walk over the skip field
    (``occupancy_skip_field``): sample in occupied cells, leap over empty
    space by whole recurrence steps, until every ray has its slab or has
    left the volume. On CPU tensors it is the plain walk,
    ``march_skip_plain``; on CUDA tensors it launches ``csrc/march_skip.cu``
    (a group of lanes walks one ray to its end, reading the skip codes of a
    run's next lattice points at once; no host read: a CUDA graph holds it)
    or raises. The kernel's samples equal the plain walk's bit for bit.

Training jitters each ray's start: ``noise`` [N] uniforms move t0 by
``noise * dt(t0)``, as the JAX package's ``perturb`` does with its own draw.
"""

from __future__ import annotations

import math
import ctypes
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

SQRT3 = math.sqrt(3.0)


class MarchResult(NamedTuple):
    ts: torch.Tensor  # [N, K] sample positions along the ray
    dts: torch.Tensor  # [N, K] step sizes
    valid: torch.Tensor  # [N, K] bool
    count: torch.Tensor  # [N] number of valid samples (<= K)
    # walk iterations (march_rays_skip): the plain walk's global count, a
    # host int; the kernel's longest ray, an int32 device scalar
    iters: Union[int, torch.Tensor] = 0
    ray_iters: Optional[torch.Tensor] = None  # [N] int32 iterations per ray (the kernel)


def candidate_ts(t0: torch.Tensor, num: int, dt_min: float, dt_max: float, dt_gamma: float):
    """Closed-form t-ladder from t0 [N] -> (ts [N, S], dts [N, S])."""
    i = torch.arange(num, dtype=torch.float32, device=t0.device)[None, :]
    t0 = t0[:, None].float()
    if dt_gamma <= 0.0:
        ts = t0 + i * dt_min
        return ts, torch.full_like(ts, dt_min)

    A = dt_min / dt_gamma  # below: linear dt_min steps
    B = dt_max / dt_gamma  # above: linear dt_max steps
    g = 1.0 + dt_gamma

    n1 = torch.ceil(torch.clamp(A - t0, min=0.0) / dt_min)
    t_n1 = t0 + n1 * dt_min
    ratio = torch.clamp(B / torch.clamp(t_n1, min=1e-30), min=1.0)
    n2 = torch.ceil(torch.log(ratio) / math.log(g))
    t_n2 = t_n1 * g**n2

    ts = torch.where(
        i <= n1,
        t0 + i * dt_min,
        torch.where(i <= n1 + n2, t_n1 * g ** (i - n1), t_n2 + (i - n1 - n2) * dt_max),
    )
    dts = torch.clamp(ts * dt_gamma, dt_min, dt_max)
    return ts, dts


def _jittered_start(nears, noise, dt_gamma: float, dt_min: float, dt_max: float):
    if noise is None:
        return nears
    return nears + torch.clamp(nears * dt_gamma, dt_min, dt_max) * noise


def _mip_level(x_absmax: torch.Tensor, dt: torch.Tensor, grid_size: int, cascades: int):
    """max(mip_from_pos, mip_from_dt), raymarching.cu:42-54 (frexp exponents)."""
    _, e_pos = torch.frexp(x_absmax)
    _, e_dt = torch.frexp(dt * grid_size * 0.5)
    return torch.clamp(torch.maximum(e_pos, e_dt), 0, cascades - 1)


def march_rays(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    nears: torch.Tensor,
    fars: torch.Tensor,
    occ_bits: torch.Tensor,  # [CAS, H^3] bool, linear (x-major) cell order
    *,
    bound: float,
    dt_gamma: float = 0.0,
    max_steps: int = 1024,
    slab: int = 128,
    grid_size: int = 128,
    noise: Optional[torch.Tensor] = None,
) -> MarchResult:
    """Sample up to ``slab`` occupied positions per ray.

    dt_min = 2*sqrt(3)/max_steps, dt_max = 2*sqrt(3)*2^(CAS-1)/H, t0 = near
    (+ dt(near) * noise when ``noise`` [N] is given).
    """
    cascades = occ_bits.shape[0]
    dt_min = 2.0 * SQRT3 / max_steps
    dt_max = 2.0 * SQRT3 * (2.0 ** (cascades - 1)) / grid_size
    t0 = _jittered_start(nears, noise, dt_gamma, dt_min, dt_max)
    ts, dts = candidate_ts(t0, max_steps, dt_min, dt_max, dt_gamma)  # [N, S]

    xyz = rays_o[:, None, :] + rays_d[:, None, :] * ts[..., None]
    xyz = torch.clamp(xyz, -bound, bound)
    level = _mip_level(xyz.abs().amax(-1), dts, grid_size, cascades)  # [N, S] int32
    mip_bound = torch.clamp(torch.exp2(level.float()), max=bound)
    cell = torch.clamp(
        (0.5 * (xyz / mip_bound[..., None] + 1.0) * grid_size).to(torch.int64),
        0,
        grid_size - 1,
    )
    flat = (
        level.to(torch.int64) * grid_size**3
        + cell[..., 0] * grid_size * grid_size
        + cell[..., 1] * grid_size
        + cell[..., 2]
    )
    occ = occ_bits.reshape(-1)[flat]
    valid = occ & (ts < fars[:, None])

    # stable sort of the invalid flags moves valid candidates to the front in
    # order (the CUDA two-pass atomicAdd compaction, raymarching.cu:405-406)
    order = torch.sort((~valid).to(torch.uint8), dim=-1, stable=True).indices[:, :slab]
    out_t = torch.gather(ts, 1, order)
    out_dt = torch.gather(dts, 1, order)
    count = torch.clamp(valid.sum(-1), max=slab)
    keep = torch.arange(slab, device=ts.device)[None, :] < count[:, None]
    zero = torch.zeros((), dtype=ts.dtype, device=ts.device)
    return MarchResult(
        ts=torch.where(keep, out_t, zero),
        dts=torch.where(keep, out_dt, zero),
        valid=keep,
        count=count,
    )


# The walk checks "any ray still marching?" (a host sync) every this many
# iterations. Iterations after every ray is done record nothing, so the
# samples are those of a check every iteration.
_CHECK_EVERY = 4


def march_rays_skip(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    nears: torch.Tensor,
    fars: torch.Tensor,
    occ_skip: torch.Tensor,  # [CAS, H^3] uint8 skip codes (occupancy_skip_field)
    *,
    bound: float,
    dt_gamma: float = 0.0,
    max_steps: int = 1024,
    slab: int = 128,
    grid_size: int = 128,
    max_iters: int = 0,
    noise: Optional[torch.Tensor] = None,
) -> MarchResult:
    """Sphere-tracing marcher over the skip field (same contract as
    ``march_rays``; the walk is ``march_skip_plain``'s).

    CPU tensors take the plain walk. CUDA tensors take the kernel, one launch
    counted in ``march_rays_skip.launches``: the start ``t0`` is the plain
    walk's torch expression, then a group of ``march_lanes(n, slab)`` lanes
    walks each ray to its end, so ``ts``, ``dts``, ``valid`` and ``count``
    equal the plain walk's bit for bit. Its ``iters`` is the longest ray's
    iteration count, an int32 device scalar read by nobody inside the walk;
    the plain walk's is a host int that counts in steps of 4 (its host
    check), so the two differ by up to 3.
    """
    if not rays_o.is_cuda:
        if rays_o.device.type != "cpu":
            raise ValueError(f"march_rays_skip: unsupported device {rays_o.device}")
        return march_skip_plain(rays_o, rays_d, nears, fars, occ_skip, bound=bound, dt_gamma=dt_gamma,
                                max_steps=max_steps, slab=slab, grid_size=grid_size, max_iters=max_iters,
                                noise=noise)
    cascades = occ_skip.shape[0]
    dt_min = 2.0 * SQRT3 / max_steps
    dt_max = 2.0 * SQRT3 * (2.0 ** (cascades - 1)) / grid_size
    if max_iters <= 0:
        max_iters = slab + 8 * grid_size
    t0 = _jittered_start(nears.float(), noise, dt_gamma, dt_min, dt_max)
    return _march_skip_launch(rays_o, rays_d, t0, fars, occ_skip, bound=bound, dt_gamma=dt_gamma,
                              dt_min=dt_min, dt_max=dt_max, slab=slab, grid_size=grid_size,
                              max_iters=max_iters)


def _f32(x: float) -> float:
    return float(np.float32(x))


def _recip(x: float) -> float:
    """The factor torch multiplies by where a CUDA tensor is divided by the
    Python float ``x``: 1 / x in double, rounded to fp32 (not fp32(1) /
    fp32(x): the two differ for x = log(1 + 1/128), measured on the card)."""
    return float(np.float32(1.0 / x))


def march_lanes(n: int, slab: int):
    """(lanes, ramp) of the kernel's walk for ``n`` rays of ``slab``: a group
    of ``lanes`` walks a ray, and a round after a leap is ``ramp`` lanes wide
    (doubled by each round that samples all its lanes). Measured on the
    H100 (PERF.md §6): 8 lanes, ramp 2 at slab 128 (the -O batch and
    D-NeRF's); 2 lanes, ramp 1 at slabs 16 and 32, where walks are mostly
    leaps; one lane from 32768 rays up (the iterative round's 65536), where
    a group's idle lanes cost more than its speculation saves."""
    if n >= 32768:
        return 1, 1
    return (8, 2) if slab >= 64 else (2, 1)


def _march_skip_launch(rays_o, rays_d, t0, fars, occ_skip, *, bound: float, dt_gamma: float, dt_min: float,
                       dt_max: float, slab: int, grid_size: int, max_iters: int) -> MarchResult:
    """Checks the operands, then launches ``focnerf_march_skip`` on the
    current stream. Every constant the plain walk takes from a Python float
    is passed as torch rounds it (an fp32 value; for a divisor, ``_recip``)."""
    from focnerf_tpu_torch.ops._build import load_library

    n = rays_o.shape[0]
    device = rays_o.device
    cascades = occ_skip.shape[0]
    # a camera's rays share one origin (an expanded, stride-0 view)
    rays_o, rays_d, t0, fars = (t.contiguous() for t in (rays_o, rays_d, t0, fars))
    for name, t, dtype, shape in (
        ("rays_o", rays_o, torch.float32, (n, 3)),
        ("rays_d", rays_d, torch.float32, (n, 3)),
        ("t0", t0, torch.float32, (n,)),
        ("fars", fars, torch.float32, (n,)),
        ("occ_skip", occ_skip, torch.uint8, (cascades, grid_size**3)),
    ):
        if t.device != device or t.dtype != dtype:
            raise ValueError(f"{name}: need {dtype} on {device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {shape}, got {tuple(t.shape)}")
    if cascades * grid_size**3 >= 2**31:
        raise ValueError(f"occ_skip: {cascades} x {grid_size}^3 cells overflow the kernel's int32 cell index")
    lanes, ramp = march_lanes(n, slab)
    out_t = torch.empty((n, slab), dtype=torch.float32, device=device)
    out_dt = torch.empty((n, slab), dtype=torch.float32, device=device)
    valid = torch.empty((n, slab), dtype=torch.bool, device=device)
    count = torch.empty((n,), dtype=torch.int64, device=device)
    ray_iters = torch.empty((n,), dtype=torch.int32, device=device)
    iters = torch.zeros((1,), dtype=torch.int32, device=device)
    fn = load_library("march_skip").focnerf_march_skip
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_float] * 15 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p] * 7)
    geometric = dt_gamma > 0.0
    err = fn(
        rays_o.data_ptr(), rays_d.data_ptr(), t0.data_ptr(), fars.data_ptr(), occ_skip.data_ptr(),
        _f32(bound), _f32(dt_gamma), _f32(dt_min), _f32(dt_max), _recip(grid_size), _recip(dt_min),
        _recip(math.log(1.0 + dt_gamma)) if geometric else 0.0, _f32(1.0 + dt_gamma),
        _f32(dt_min / dt_gamma) if geometric else 0.0, _f32(dt_max / dt_gamma) if geometric else 0.0,
        float(grid_size), _f32(SQRT3), _f32(1e-3), _f32(1e-12), _f32(1e-6),
        grid_size, cascades, slab, max_iters, int(geometric), lanes, ramp, n,
        out_t.data_ptr(), out_dt.data_ptr(), valid.data_ptr(), count.data_ptr(), ray_iters.data_ptr(),
        iters.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"skip-march kernel launch failed: cudaError {err}")
    march_rays_skip.launches += 1
    return MarchResult(ts=out_t, dts=out_dt, valid=valid, count=count, iters=iters[0], ray_iters=ray_iters)


march_rays_skip.launches = 0


def march_skip_plain(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    nears: torch.Tensor,
    fars: torch.Tensor,
    occ_skip: torch.Tensor,  # [CAS, H^3] uint8 skip codes (occupancy_skip_field)
    *,
    bound: float,
    dt_gamma: float = 0.0,
    max_steps: int = 1024,
    slab: int = 128,
    grid_size: int = 128,
    max_iters: int = 0,
    noise: Optional[torch.Tensor] = None,
) -> MarchResult:
    """The plain version of ``march_rays_skip``, on any device.

    Each iteration either samples (skip code 0: occupied cell, advance by
    the dt recurrence) or leaps over empty space (code v >= 1: past the cell
    boundary plus v - 2 safe cells) by a whole number of recurrence steps, so
    landings stay on the jittered lattice; a leap stops at the first lattice
    point past a dt phase boundary. The walk ends when every ray has
    ``slab`` samples or has passed ``far``, or after ``max_iters``
    iterations (default slab + 8 * grid_size).
    """
    n = rays_o.shape[0]
    device = rays_o.device
    cascades = occ_skip.shape[0]
    dt_min = 2.0 * SQRT3 / max_steps
    dt_max = 2.0 * SQRT3 * (2.0 ** (cascades - 1)) / grid_size
    if max_iters <= 0:
        max_iters = slab + 8 * grid_size

    t = _jittered_start(nears.float(), noise, dt_gamma, dt_min, dt_max)
    skip_flat = occ_skip.reshape(-1)
    k_iota = torch.arange(slab, device=device)[None, :]
    count = torch.zeros((n,), dtype=torch.int64, device=device)
    out_t = torch.zeros((n, slab), device=device)
    out_dt = torch.zeros((n, slab), device=device)
    step_dir = (rays_d > 0).to(torch.int64)
    d_safe = torch.where(rays_d.abs() < 1e-12, torch.sign(rays_d) + 1e-12, rays_d)

    it = 0
    while it < max_iters:
        if it % _CHECK_EVERY == 0 and not bool(((t < fars) & (count < slab)).any()):
            break
        it += 1
        alive = t < fars
        dt = torch.clamp(t * dt_gamma, dt_min, dt_max)
        xyz = torch.clamp(rays_o + rays_d * t[:, None], -bound, bound)
        level = _mip_level(xyz.abs().amax(-1), dt, grid_size, cascades)
        mip_bound = torch.clamp(torch.exp2(level.float()), max=bound)
        cs = 2.0 * mip_bound / grid_size  # cell size at this level [N]
        cell_f = 0.5 * (xyz / mip_bound[:, None] + 1.0) * grid_size
        cell = torch.clamp(cell_f.to(torch.int64), 0, grid_size - 1)
        flat = (
            level.to(torch.int64) * grid_size**3
            + cell[:, 0] * grid_size * grid_size
            + cell[:, 1] * grid_size
            + cell[:, 2]
        )
        v = skip_flat[flat]
        occupied = (v == 0) & alive

        # record the sample where occupied and count < slab
        put = occupied & (count < slab)
        mask_k = (k_iota == count[:, None]) & put[:, None]
        out_t = torch.where(mask_k, t[:, None], out_t)
        out_dt = torch.where(mask_k, dt[:, None], out_dt)
        count = count + put.to(count.dtype)

        # advance: one dt step through occupied cells; past the cell exit
        # (+ safe extra cells) through empty space, in whole dt steps
        next_corner = (cell + step_dir).float()
        world_next = (next_corner / grid_size * 2.0 - 1.0) * mip_bound[:, None]
        t_axes = (world_next - xyz) / d_safe
        t_exit = torch.where(t_axes > 0, t_axes, torch.full_like(t_axes, math.inf)).amin(-1)
        t_exit = torch.minimum(t_exit, SQRT3 * cs)  # guard degenerate geometry
        extra = torch.clamp(v.float() - 2.0, min=0.0) * cs
        s_want = t_exit + 1e-3 * cs + extra  # required safe advance
        if dt_gamma <= 0.0:
            adv_empty = (torch.floor(s_want / dt_min) + 1.0) * dt_min
        else:
            g = 1.0 + dt_gamma
            t_lo = dt_min / dt_gamma  # below: dt pinned at dt_min
            t_hi = dt_max / dt_gamma  # above: dt pinned at dt_max
            m_lin = torch.floor(s_want / dt) + 1.0
            m_lo_b = torch.clamp(torch.floor((t_lo - t) / dt_min) + 1.0, min=1.0)
            t_pos = torch.clamp(t, min=1e-6)
            m_geo = torch.ceil(torch.log1p(s_want / t_pos) / math.log(g))
            m_geo_b = torch.ceil(torch.log(torch.clamp(t_hi / t_pos, min=1.0)) / math.log(g))
            m_g = torch.minimum(torch.clamp(m_geo, min=1.0), torch.clamp(m_geo_b, min=1.0))
            below = t * dt_gamma <= dt_min
            above = t * dt_gamma >= dt_max
            adv_empty = torch.where(
                below,
                torch.minimum(m_lin, m_lo_b) * dt,
                torch.where(above, m_lin * dt, t * g**m_g - t),
            )
        t = t + torch.where(occupied, dt, adv_empty)
        done = (count >= slab) | ~alive
        t = torch.where(done & ~occupied, torch.maximum(t, fars), t)

    keep = k_iota < count[:, None]
    return MarchResult(ts=out_t, dts=out_dt, valid=keep, count=count, iters=it)
