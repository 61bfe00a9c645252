"""Occupancy-grid state, bitfield, maintenance updates and skip field.

Twin of focnerf_tpu/ops/occupancy.py: the density grid [CAS, H^3] (plain
linear x-major cell order), its bitfield ``density > min(mean, thresh)``,
the LSB-first pack/unpack of raymarching.cu, ``update_occupancy`` (full
sweeps for the first 16 updates, then a quarter of the cells at random plus
as many occupied cells drawn by inverse CDF; EMA decay 0.95),
``mark_untrained_grid`` (cells no training camera sees become -1) and
``occupancy_skip_field`` (per-cell empty-space leap codes for
``march_rays_skip``; the dilation doubling runs as separable ``max_pool3d``).

torch cannot reproduce the JAX PRNG, so the update takes its draws as
tensors (``occupancy_draws`` makes them from a ``torch.Generator``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple

import torch


class OccupancyState(NamedTuple):
    density_grid: torch.Tensor  # [CAS, H^3] f32; -1 marks untrained cells
    mean_density: torch.Tensor  # scalar f32
    iter_density: torch.Tensor  # scalar i32


def cascade_count(bound: float) -> int:
    return 1 + math.ceil(math.log2(max(bound, 1.0)))


def init_occupancy(bound: float, device, grid_size: int = 128) -> OccupancyState:
    cas = cascade_count(bound)
    return OccupancyState(
        density_grid=torch.zeros((cas, grid_size**3), dtype=torch.float32, device=device),
        mean_density=torch.zeros((), dtype=torch.float32, device=device),
        iter_density=torch.zeros((), dtype=torch.int32, device=device),
    )


def occupancy_bitfield(occ: OccupancyState, density_thresh: float) -> torch.Tensor:
    """Bool grid [CAS, H^3]: cell occupied iff density > min(mean, thresh)."""
    thresh = torch.clamp(occ.mean_density, max=density_thresh)
    return occ.density_grid > thresh


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Bool [..., 8k] -> uint8 [..., k] (LSB-first, as raymarching.cu:268-300)."""
    b = bits.reshape(*bits.shape[:-1], -1, 8).to(torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    return (b << shifts).sum(-1, dtype=torch.uint8)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], -1).bool()


def _cell_coords01(idx: torch.Tensor, grid_size: int) -> torch.Tensor:
    """Flat x-major cell indices [M] -> cell coords in [-1, 1], [M, 3] f32
    (``2 * coord / (H - 1) - 1``)."""
    coords = torch.stack(
        [idx // (grid_size * grid_size), (idx // grid_size) % grid_size, idx % grid_size], -1
    )
    return 2.0 * coords.float() / (grid_size - 1) - 1.0


def _cascade_world_coords(coords01, cas: int, bound: float, grid_size: int):
    """Map [-1,1] cell coords to cascade ``cas`` world coords (renderer.py:448-452)."""
    cas_bound = min(2.0**cas, bound)
    half = cas_bound / grid_size
    return coords01 * (cas_bound - half), half


def occupancy_draws(
    generator: torch.Generator, n_cascades: int, full: bool, device, grid_size: int = 128
) -> Dict[str, torch.Tensor]:
    """The draws of one ``update_occupancy``: ``jitter`` uniforms [CAS, M, 3]
    (M = H^3 for a full sweep, 2 * H^3 // 4 for a partial one) and, for a
    partial sweep, ``rand_idx`` [CAS, H^3 // 4] cells and ``u`` [CAS,
    H^3 // 4] uniforms for the inverse-CDF pick of occupied cells."""
    n_cells = grid_size**3
    kw = dict(generator=generator, device=device)
    if full:
        return {"jitter": torch.rand((n_cascades, n_cells, 3), **kw)}
    n = n_cells // 4
    return {
        "rand_idx": torch.randint(0, n_cells, (n_cascades, n), **kw),
        "u": torch.rand((n_cascades, n), **kw),
        "jitter": torch.rand((n_cascades, 2 * n, 3), **kw),
    }


@torch.no_grad()
def update_occupancy(
    occ: OccupancyState,
    density_eval: Callable[[torch.Tensor], torch.Tensor],
    draws: Dict[str, torch.Tensor],
    *,
    bound: float,
    density_scale: float = 1.0,
    decay: float = 0.95,
    grid_size: int = 128,
    chunk: int = 2**17,
) -> OccupancyState:
    """One maintenance step of the density grid (nerf/renderer.py:419-507).

    ``density_eval``: xyz [M, 3] -> sigma [M]. ``draws`` from
    ``occupancy_draws``: a full sweep when they hold no ``rand_idx``. The
    caller picks full for the first 16 updates, as the reference does.
    Returns a new state; ``occ`` is not modified.
    """
    cas_total = occ.density_grid.shape[0]
    n_cells = grid_size**3
    device = occ.density_grid.device

    def query_density(xyzs):
        return torch.cat(
            [density_eval(xyzs[i : i + chunk]) for i in range(0, xyzs.shape[0], chunk)]
        ) * density_scale

    if "rand_idx" not in draws:
        all_cells = _cell_coords01(torch.arange(n_cells, device=device), grid_size)
        tmp = []
        for cas in range(cas_total):
            cxyz, half = _cascade_world_coords(all_cells, cas, bound, grid_size)
            jitter = (draws["jitter"][cas] * 2.0 - 1.0) * half
            tmp.append(query_density(cxyz + jitter))
        tmp_grid = torch.stack(tmp)
    else:
        tmp_grid = torch.full((cas_total, n_cells), -1.0, device=device)
        for cas in range(cas_total):
            rand_idx = draws["rand_idx"][cas]
            # resample currently-occupied cells via inverse CDF over the >0 mask
            cdf = torch.cumsum((occ.density_grid[cas] > 0).float(), 0)
            total = cdf[-1]
            u = draws["u"][cas] * torch.clamp(total, min=1.0)
            occ_idx = torch.clamp(torch.searchsorted(cdf, u, side="left"), 0, n_cells - 1)
            # nothing occupied yet -> fall back to the uniform half
            occ_idx = torch.where(total > 0, occ_idx, rand_idx)
            idx = torch.cat([rand_idx, occ_idx])
            cxyz, half = _cascade_world_coords(_cell_coords01(idx, grid_size), cas, bound, grid_size)
            jitter = (draws["jitter"][cas] * 2.0 - 1.0) * half
            tmp_grid[cas, idx] = query_density(cxyz + jitter)

    grid = occ.density_grid
    valid = (grid >= 0) & (tmp_grid >= 0)
    new_grid = torch.where(valid, torch.maximum(grid * decay, tmp_grid), grid)
    return OccupancyState(
        density_grid=new_grid,
        mean_density=torch.clamp(new_grid, min=0.0).mean(),
        iter_density=occ.iter_density + 1,
    )


@torch.no_grad()
def mark_untrained_grid(
    occ: OccupancyState,
    poses,  # [B, 4, 4] c2w
    intrinsics,
    *,
    bound: float,
    grid_size: int = 128,
    chunk: int = 2**16,
) -> OccupancyState:
    """Mark cells never seen by any training camera as -1 (renderer.py:356-417)."""
    fx, fy, cx, cy = (float(v) for v in intrinsics)
    device = occ.density_grid.device
    poses = torch.as_tensor(poses, dtype=torch.float32).to(device)
    R, T = poses[:, :3, :3], poses[:, :3, 3]
    coords01 = _cell_coords01(torch.arange(grid_size**3, device=device), grid_size)
    grids = []
    for cas in range(occ.density_grid.shape[0]):
        world, half = _cascade_world_coords(coords01, cas, bound, grid_size)
        seen = []
        for i in range(0, world.shape[0], chunk):
            # world -> cam: (p - t) @ R (ref :400-402)
            cam = torch.einsum("nbi,bij->nbj", world[i : i + chunk, None, :] - T[None], R)
            mz = cam[..., 2] > 0
            mx = cam[..., 0].abs() < cx / fx * cam[..., 2] + half * 2
            my = cam[..., 1].abs() < cy / fy * cam[..., 2] + half * 2
            seen.append((mz & mx & my).any(1))
        grids.append(torch.where(torch.cat(seen), occ.density_grid[cas], -1.0))
    return occ._replace(density_grid=torch.stack(grids))


@torch.no_grad()
def occupancy_skip_field(occ_bits: torch.Tensor, grid_size: int = 128) -> torch.Tensor:
    """Per-cell empty-space skip codes [CAS, H^3] uint8 from the bitfield.

    0 for an occupied cell; otherwise k + 1 for the largest k in {1, 2, 4,
    ..., H/2} with no occupied cell within L-inf distance k (1 when even
    k = 1 fails). Built by dilation doubling (B_2k = B_k + B_k), each
    dilation three 1-D max-pools of the 0/1 field, exactly as the JAX
    package's ``reduce_window`` rounds. A 1-D max-pool of radius r over a
    0/1 field is "any occupied cell in the window [i - r, i + r], clipped
    at the edges": a difference of prefix counts (the max-pool's result,
    without its (2r + 1)-wide window per cell).
    """
    cas = occ_bits.shape[0]
    occ = occ_bits.reshape(1, cas, grid_size, grid_size, grid_size).float()

    def max_pool_1d(v, dim, r):
        n = v.shape[dim]
        pad = list(v.shape)
        pad[dim] = r
        zeros = v.new_zeros(pad)
        # v's window [i - r, i + r] is padded[i + 1 : i + 2r + 2]
        padded = torch.cat([zeros, v.new_zeros(pad[:dim] + [1] + pad[dim + 1:]), v, zeros], dim)
        counts = torch.cumsum(padded, dim, dtype=torch.int32)
        return (counts.narrow(dim, 2 * r + 1, n) > counts.narrow(dim, 0, n)).to(v.dtype)

    def dilate(v, r):
        for axis in range(3):
            v = max_pool_1d(v, 2 + axis, r)
        return v

    skip = torch.where(occ > 0, 0, 1).to(torch.uint8)
    dil = occ
    k = 1
    while k <= min(grid_size // 2, 127):
        dil = dilate(dil, k // 2 if k > 1 else 1)  # doubling: radius k total
        skip = torch.where((dil == 0) & (skip > 0), k + 1, skip).to(torch.uint8)
        k *= 2
    return skip.reshape(cas, -1)
