"""Multiresolution hash-grid encoding (Instant-NGP) and its table gradient.

Twin of focnerf_tpu/ops/hashgrid.py (``HashGridSpec.create``,
``_level_corner_indices``, ``_level_sampled_indices``, ``_coords_to_rows``,
``_is_stochastic_level``, ``_col_layout``, ``_encode_impl`` and the custom
VJP ``_encode_sorted_bwd``), in plain PyTorch:

  - per level l: scale ``exp2(l * log2 s) * base - 1`` and the ``+0.5``
    offset of gridencoder.cu, corner bit d -> +1 in dim d;
  - dense levels index with strides (R_l+1)^d; overflowing levels use the
    XOR-prime hash. The JAX package hashes in uint32; here the product is
    taken in int64 and masked with ``& 0xFFFFFFFF`` after every multiply,
    which keeps exactly the uint32 low bits, then ``% size``;
  - inputs outside [0, 1] encode to zeros;
  - level-major output ``out[:, l*C + c]``;
  - training's stochastic corners: with uniforms ``u`` [N, n_stoch, K, D]
    passed in, each stochastic level (hashed, or dense with at least
    ``stochastic_min_size`` rows) resolves K corners drawn with probability
    equal to their trilinear weight (D Bernoulli(frac_d) draws), each of
    weight 1/K.

The table gradient is ``HashGridEncode``'s backward, as the JAX custom VJP's:
``hashgrid_table_grad`` scatters ``weights * g`` into the table rows the
forward read. On CPU tensors that is ``index_add_``; on CUDA tensors it
launches ``csrc/hashgrid_bwd.cu`` (the port of
``hashgrid_pallas.py::hashgrid_bwd_level``, all levels in one launch, a
warp's duplicate rows summed before its atomics) or raises.

The forward is ``hashgrid_encode_forward``: on CPU tensors its plain
version ``encode_plain`` (a torch loop over the levels); on CUDA tensors it
launches ``csrc/hashgrid_fwd.cu``'s encode kernel (a block takes a tile of
points and all their levels, staged through shared memory; the level table
and the tile, ``encode_tile``, passed by value) or raises. JAX leaves
this function to XLA (``_encode_impl``); no Pallas kernel stood there.

When the points require grad, the backward also gives them theirs
(``hashgrid_input_grad``): JAX's ``input_grads=True`` encode, which the
D-NeRF fields learn through. On CPU tensors it is ``input_grad_plain``; on
CUDA tensors the same source's position-gradient kernel. Such an encode is
always exact, as JAX's is: it draws no corners.

``-O2``'s two levers and the TV term, as in the JAX twin:

  - ``HashGridSpec.grad_levels``: the backward scatters only the columns of
    these levels, so the kernel runs on the subset and every other level's
    rows get exactly 0 (the forward is unchanged);
  - ``HashGridSpec.truncate`` and ``hashgrid_encode_c2f``: a coarse-to-fine
    stage encodes the first ``active`` levels from a prefix slice of the
    table and zero-fills the fine levels' features;
  - ``hashgrid_tv_loss``: the table's total variation at sampled points,
    plain torch (a gather; no kernel computes it).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437, 2165219737)
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class HashGridSpec:
    """Static description of a hash-grid encoding (same numbers as JAX)."""

    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    per_level_scale: float = 2.0
    input_dim: int = 3
    # training: K stochastic corners on hashed levels and on dense levels of
    # at least stochastic_min_size rows (0: hashed only); 0 = exact
    stochastic_k: int = 0
    stochastic_min_size: int = 0
    # the levels whose table rows get a gradient (None: all); -O2's
    # alternating phases train one subset a step
    grad_levels: Optional[Tuple[int, ...]] = None
    resolutions: Tuple[int, ...] = ()
    offsets: Tuple[int, ...] = ()  # num_levels + 1 entries, in table rows
    hashed: Tuple[bool, ...] = ()

    @classmethod
    def create(
        cls,
        num_levels: int = 16,
        level_dim: int = 2,
        base_resolution: int = 16,
        log2_hashmap_size: int = 19,
        per_level_scale: float | None = None,
        desired_resolution: float | None = None,
        input_dim: int = 3,
    ) -> "HashGridSpec":
        if desired_resolution is not None:
            per_level_scale = float(
                np.exp2(np.log2(desired_resolution / base_resolution) / (num_levels - 1))
            )
        if per_level_scale is None:
            raise ValueError("give per_level_scale or desired_resolution")
        max_params = 2**log2_hashmap_size
        resolutions, offsets, hashed = [], [0], []
        offset = 0
        for lvl in range(num_levels):
            res = int(np.ceil(base_resolution * per_level_scale**lvl))
            dense_size = (res + 1) ** input_dim
            params_in_level = int(np.ceil(min(max_params, dense_size) / 8) * 8)
            resolutions.append(res)
            hashed.append(dense_size > max_params)
            offset += params_in_level
            offsets.append(offset)
        return cls(
            num_levels=num_levels,
            level_dim=level_dim,
            base_resolution=base_resolution,
            log2_hashmap_size=log2_hashmap_size,
            per_level_scale=float(per_level_scale),
            input_dim=input_dim,
            resolutions=tuple(resolutions),
            offsets=tuple(offsets),
            hashed=tuple(hashed),
        )

    def truncate(self, active: int) -> "HashGridSpec":
        """The spec of the first ``active`` levels (a coarse-to-fine stage).
        Offsets are cumulative, so its table is ``table[:sub.table_rows]``."""
        if not 0 < active <= self.num_levels:
            raise ValueError(f"active={active} outside [1, {self.num_levels}]")
        gl = self.grad_levels
        if gl is not None:
            gl = tuple(lvl for lvl in gl if lvl < active) or None
        return dataclasses.replace(
            self, num_levels=active, resolutions=self.resolutions[:active],
            offsets=self.offsets[: active + 1], hashed=self.hashed[:active], grad_levels=gl,
        )

    @property
    def table_rows(self) -> int:
        return self.offsets[-1]

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    def level_size(self, lvl: int) -> int:
        return self.offsets[lvl + 1] - self.offsets[lvl]


def hashgrid_init(spec: HashGridSpec, generator: torch.Generator, device) -> torch.Tensor:
    """Uniform(-1e-4, 1e-4) table [table_rows, C] (gridencoder/grid.py:138-140).

    Drawn on the CPU from ``generator`` so a seed gives the same table on
    every device, then moved to ``device``.
    """
    u = torch.rand((spec.table_rows, spec.level_dim), generator=generator)
    return ((u * 2.0 - 1.0) * 1e-4).to(device)


def _coords_to_rows(coords: torch.Tensor, spec: HashGridSpec, lvl: int) -> torch.Tensor:
    """Integer vertex coords [..., D] (int64, >= 0) -> flat table rows [...]."""
    if spec.hashed[lvl]:
        h = torch.zeros(coords.shape[:-1], dtype=torch.int64, device=coords.device)
        for d in range(spec.input_dim):
            h = h ^ ((coords[..., d] * _PRIMES[d]) & _U32)
        idx = h % spec.level_size(lvl)
    else:
        stride = 1
        idx = torch.zeros(coords.shape[:-1], dtype=torch.int64, device=coords.device)
        for d in range(spec.input_dim):
            idx = idx + coords[..., d] * stride
            stride *= spec.resolutions[lvl] + 1
    return idx + spec.offsets[lvl]


def _level_corner_indices(x01: torch.Tensor, spec: HashGridSpec, lvl: int):
    """(rows [N, 2^D] int64 into the flat table, weights [N, 2^D] f32)."""
    D = spec.input_dim
    pos = x01 * _level_scale(spec, lvl) + 0.5
    pos_grid = torch.floor(pos)
    frac = pos - pos_grid
    base = pos_grid.to(torch.int64)  # [N, D]
    bits = _corner_bits(D, x01.device)  # built on the device (no host copy)
    w = torch.where(bits[None] > 0, frac[:, None, :], 1.0 - frac[:, None, :]).prod(-1)
    rows = _coords_to_rows(base[:, None, :] + bits[None], spec, lvl)
    return rows, w


def _level_scale(spec: HashGridSpec, lvl: int) -> float:
    return float(
        np.float32(np.exp2(lvl * np.log2(spec.per_level_scale)) * spec.base_resolution - 1.0)
    )


def _level_sampled_indices(x01: torch.Tensor, spec: HashGridSpec, lvl: int, u3: torch.Tensor):
    """Rows [N, K] (int64) of K corners drawn by weight: the trilinear weight
    factorizes per axis, so corner bit d is the Bernoulli draw u3[..., d] <
    frac_d (u3 [N, K, D] uniforms in [0, 1))."""
    pos = x01 * _level_scale(spec, lvl) + 0.5
    pos_grid = torch.floor(pos)
    frac = pos - pos_grid  # [N, D]
    bits = (u3 < frac[:, None, :]).to(torch.int64)  # [N, K, D]
    return _coords_to_rows(pos_grid.to(torch.int64)[:, None, :] + bits, spec, lvl)


@functools.lru_cache(maxsize=None)
def _is_stochastic_level(spec: HashGridSpec, lvl: int) -> bool:
    if spec.stochastic_k <= 0:
        return False
    if spec.hashed[lvl]:
        return True
    return spec.stochastic_min_size > 0 and spec.level_size(lvl) >= spec.stochastic_min_size


def stochastic_levels(spec: HashGridSpec) -> Tuple[int, ...]:
    """The levels a training encode resolves stochastically (``u``'s axis 1)."""
    return tuple(lvl for lvl in range(spec.num_levels) if _is_stochastic_level(spec, lvl))


def col_levels(spec: HashGridSpec, stochastic: bool) -> Tuple[int, ...]:
    """Level of every packed (level, corner) column of the encode's
    residuals: 2^D columns for an exact level, K for a stochastic one."""
    stoch = stochastic_levels(spec) if stochastic else ()
    cols = []
    for lvl in range(spec.num_levels):
        cols += [lvl] * (spec.stochastic_k if lvl in stoch else 1 << spec.input_dim)
    return tuple(cols)


def hashgrid_encode_forward(table, x01, spec: HashGridSpec, u: Optional[torch.Tensor], residuals: bool):
    """Shared forward -> (out [N, L*C], rows [N, J] int32 or None, weights
    [N, J] or None); rows/weights only when ``residuals``, in the column
    order of ``col_levels(spec, u is not None)``.

    CPU tensors: ``encode_plain``. CUDA tensors: the encode kernel, one
    launch counted in ``hashgrid_encode_forward.launches``; its rows equal
    the plain version's bit for bit, its weights and out agree to a few ulp
    (products and sums in index order; torch may reduce in another)."""
    if not table.is_cuda:
        if table.device.type != "cpu":
            raise ValueError(f"hashgrid_encode_forward: unsupported device {table.device}")
        return encode_plain(table, x01, spec, u, residuals)
    return _encode_launch(table, x01, spec, u, residuals)


hashgrid_encode_forward.launches = 0


def encode_plain(table, x01, spec: HashGridSpec, u: Optional[torch.Tensor], residuals: bool):
    """The plain version of ``hashgrid_encode_forward`` (a torch loop over
    the levels), on any device."""
    x = x01.reshape(-1, spec.input_dim).float()
    n = x.shape[0]
    oob = ((x < 0.0) | (x > 1.0)).any(-1)
    # out-of-range points get zero weights; moving them to the origin keeps
    # every dense-level row inside the table
    x = torch.where(oob[:, None], torch.zeros_like(x), x)
    keep = (~oob).float()[:, None]
    stoch = stochastic_levels(spec) if u is not None else ()
    if stoch and tuple(u.shape) != (n, len(stoch), spec.stochastic_k, spec.input_dim):
        raise ValueError(
            f"u: need shape {(n, len(stoch), spec.stochastic_k, spec.input_dim)}, got {tuple(u.shape)}"
        )
    outs, rows_l, w_l = [], [], []
    for lvl in range(spec.num_levels):
        if lvl in stoch:
            rows = _level_sampled_indices(x, spec, lvl, u[:, stoch.index(lvl)])
            w = torch.full(rows.shape, 1.0 / spec.stochastic_k, device=x.device)
        else:
            rows, w = _level_corner_indices(x, spec, lvl)
        w = w * keep
        outs.append((w[..., None] * table[rows]).sum(1))  # [N, C]
        if residuals:
            rows_l.append(rows.to(torch.int32))
            w_l.append(w)
    out = torch.cat(outs, dim=-1)
    if not residuals:
        return out, None, None
    return out, torch.cat(rows_l, 1), torch.cat(w_l, 1)


class HashGridEncode(torch.autograd.Function):
    """Encode with the table gradient of the JAX custom VJP: the forward
    saves (rows, weights); the backward is ``hashgrid_table_grad``. When
    ``x01`` requires grad (then ``u`` must be None) the backward also
    returns its gradient, ``hashgrid_input_grad``. Draws get none."""

    @staticmethod
    def forward(ctx, table, x01, u, spec):
        out, rows, weights = hashgrid_encode_forward(table, x01, spec, u, residuals=True)
        ctx.spec = spec
        ctx.input_grad = ctx.needs_input_grad[1]
        if ctx.input_grad and u is not None:
            raise ValueError("position gradients need the exact encode: pass no corner draws u")
        cols = col_levels(spec, u is not None)
        if spec.grad_levels is not None:
            # the backward reads only the live levels' columns (JAX's col_sel)
            live = tuple(j for j, lvl in enumerate(cols) if lvl in spec.grad_levels)
            sel = _device_tuple(live, torch.int64, rows.device)
            rows = rows.index_select(1, sel)
            weights = weights.index_select(1, sel)
            cols = tuple(cols[j] for j in live)
        ctx.save_for_backward(rows, weights, table if ctx.input_grad else None,
                              x01 if ctx.input_grad else None)
        ctx.cols = cols
        ctx.n_rows = table.shape[0]
        ctx.level_dim = spec.level_dim
        return out

    @staticmethod
    def backward(ctx, g):
        rows, weights, table, x01 = ctx.saved_tensors
        d_table = d_x = None
        if ctx.needs_input_grad[0]:
            if not ctx.cols:  # no live level: every row's gradient is 0
                d_table = torch.zeros((ctx.n_rows, ctx.level_dim), device=g.device)
            else:
                d_table = hashgrid_table_grad(rows, weights, g, ctx.cols, ctx.n_rows,
                                              level_dim=ctx.level_dim)
        if ctx.input_grad:
            d_x = hashgrid_input_grad(table, x01, g, ctx.spec).to(x01.dtype)
        return d_table, d_x, None, None


def _corner_bits(D: int, device) -> torch.Tensor:
    """[2^D, D] int64: corner c has bit d -> +1 in dim d."""
    corners = torch.arange(1 << D, device=device)
    return (corners[:, None] >> torch.arange(D, device=device)) & 1


def hashgrid_input_grad(table: torch.Tensor, x01: torch.Tensor, g: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """d(loss)/d(x01), shaped as ``x01``, of the exact encode, from the
    output cotangent g [N, L*C]: for every level l and corner j,
    ``(g_l . table[rows_j]) * dw_j/dx``. The 2^D-linear weight is a product
    over axes, w_j = prod_d f_jd with f_jd = frac_d or 1 - frac_d, so
    ``dw_j/dx_d = scale_l * (+-1) * prod_{e != d} f_je``. Points outside
    [0, 1]^D get exactly 0 (their weights are 0 in the forward, as JAX masks
    them). The rows are recomputed from x01. JAX leaves this to XLA
    (autodiff of the encode); the
    reference computes it in gridencoder.cu's ``kernel_input_backward``.

    CPU tensors: ``input_grad_plain``. CUDA tensors: the position-gradient
    kernel of ``csrc/hashgrid_fwd.cu``, one launch counted in
    ``hashgrid_input_grad.launches`` (each point's levels added in order:
    deterministic)."""
    if not table.is_cuda:
        if table.device.type != "cpu":
            raise ValueError(f"hashgrid_input_grad: unsupported device {table.device}")
        return input_grad_plain(table, x01, g, spec)
    return _input_grad_launch(table, x01, g, spec)


hashgrid_input_grad.launches = 0


def input_grad_plain(table: torch.Tensor, x01: torch.Tensor, g: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """The plain version of ``hashgrid_input_grad`` (torch, a loop over the
    levels), on any device."""
    D, C = spec.input_dim, spec.level_dim
    x = x01.detach().reshape(-1, D).float()
    n = x.shape[0]
    oob = ((x < 0.0) | (x > 1.0)).any(-1)
    x = torch.where(oob[:, None], torch.zeros_like(x), x)
    g = g.reshape(n, -1).float()
    bits = _corner_bits(D, x.device)  # [K, D]
    sign = (bits * 2 - 1).float()
    gx = torch.zeros_like(x)
    for lvl in range(spec.num_levels):
        scale = _level_scale(spec, lvl)
        pos = x * scale + 0.5
        pos_grid = torch.floor(pos)
        frac = pos - pos_grid
        r = _coords_to_rows(pos_grid.to(torch.int64)[:, None, :] + bits[None], spec, lvl)
        gv = (table[r].float() * g[:, None, lvl * C : (lvl + 1) * C]).sum(-1)  # [N, K]
        f = torch.where(bits[None] > 0, frac[:, None, :], 1.0 - frac[:, None, :])  # [N, K, D]
        for d in range(D):
            others = torch.cat([f[..., :d], f[..., d + 1 :]], -1).prod(-1)  # [N, K]
            gx[:, d] += scale * (gv * others * sign[:, d]).sum(-1)
    gx = torch.where(oob[:, None], torch.zeros_like(gx), gx)
    return gx.reshape(x01.shape)


def hashgrid_encode(
    table: torch.Tensor, x01: torch.Tensor, spec: HashGridSpec, u: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Encode points x01 [..., D] in [0, 1] -> features [..., L * C].

    Exact unless ``u`` is given, ``spec.stochastic_k > 0`` and ``x01``
    needs no gradient (training): ``u`` [N, n_stoch, K, D] holds the corner
    draws, N the flattened point count, in the JAX package's shape and
    order. Differentiable (``HashGridEncode``) when autograd needs the
    table's or the points' gradient; the points' makes the encode exact, as
    JAX's ``input_grads=True`` does.
    """
    prefix = x01.shape[:-1]
    grad = torch.is_grad_enabled() and (table.requires_grad or x01.requires_grad)
    if spec.stochastic_k <= 0 or (grad and x01.requires_grad):
        u = None
    if grad:
        out = HashGridEncode.apply(table, x01, u, spec)
    else:
        out, _, _ = hashgrid_encode_forward(table, x01, spec, u, residuals=False)
    return out.reshape(*prefix, spec.output_dim)


def hashgrid_encode_c2f(
    table: torch.Tensor, x01: torch.Tensor, spec: HashGridSpec, active_levels: int,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Coarse-to-fine encode: only the first ``active_levels`` levels, from
    the table's prefix slice, with the fine levels' feature slots 0 (0 or
    at least ``num_levels``: the full encode). ``u`` is sized by the
    truncated spec's stochastic levels. The fine rows get exactly 0 of
    gradient (the cotangent of the slice)."""
    if active_levels <= 0 or active_levels >= spec.num_levels:
        return hashgrid_encode(table, x01, spec, u)
    sub = spec.truncate(active_levels)
    out = hashgrid_encode(table[: sub.table_rows], x01, sub, u)
    pad = out.new_zeros((*out.shape[:-1], spec.output_dim - sub.output_dim))
    return torch.cat([out, pad], dim=-1)


def hashgrid_tv_loss(table: torch.Tensor, x01: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """Total variation of the table at sampled points x01 [..., D]
    (gridencoder.cu ``kernel_grad_tv``): per level and axis, the
    root-sum-square over channels of the base vertex's feature difference
    to its +1 and -1 neighbours (where they exist), summed, divided by 2D
    and averaged over points. Autograd credits both vertices."""
    x = x01.reshape(-1, spec.input_dim).float()
    D = spec.input_dim
    total = table.new_zeros((), dtype=torch.float32)
    for lvl in range(spec.num_levels):
        res = spec.resolutions[lvl]
        pos_grid = torch.floor(x * _level_scale(spec, lvl) + 0.5).to(torch.int64)
        v0 = table[_coords_to_rows(pos_grid, spec, lvl)].float()
        for d in range(D):
            cur = pos_grid[:, d]
            for side in (+1, -1):
                ok = (cur < res) if side > 0 else (cur > 0)
                moved = cur + 1 if side > 0 else torch.clamp(cur, min=1) - 1
                nb = pos_grid.clone()
                nb[:, d] = torch.where(ok, moved, cur)
                vn = table[_coords_to_rows(nb, spec, lvl)].float()
                e = torch.sqrt(((v0 - vn) ** 2).sum(-1) + 1e-9)
                total = total + torch.where(ok, e, torch.zeros_like(e)).sum()
    return total / (2 * D) / x.shape[0]


@functools.lru_cache(maxsize=None)
def _device_tuple(values: Tuple[int, ...], dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A constant tuple as a tensor on ``device``, copied there once."""
    return torch.tensor(values, dtype=dtype, device=device)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device: torch.device):
    """A kernel operand's device, dtype, shape and contiguity, or ValueError."""
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name}: need {dtype} on {device}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {shape}, got {tuple(t.shape)}")


def hashgrid_table_grad(
    rows: torch.Tensor, weights: torch.Tensor, g: torch.Tensor, cols: Tuple[int, ...], n_rows: int,
    level_dim: Optional[int] = None,
) -> torch.Tensor:
    """d_table [n_rows, C] f32: ``d_table[rows[n, j]] += weights[n, j] *
    g[n, cols[j]*C : cols[j]*C + C]`` for every point n and packed column j.

    rows [N, J] int32, weights [N, J] f32, g [N, L*C] the output cotangent
    (cast to fp32), ``cols`` the level of each column (``col_levels``, or
    the live levels' columns of it), ``level_dim`` C (default: g's width
    over the levels up to the last in ``cols``). Rows nothing touches stay
    exactly 0. CPU tensors: ``index_add_``. CUDA tensors: the scatter
    kernel, one launch counted in ``hashgrid_table_grad.launches``.
    """
    n, J = rows.shape
    C = level_dim if level_dim is not None else g.shape[-1] // (max(cols) + 1)
    g = g.reshape(n, -1).float().contiguous()
    col_level = _device_tuple(tuple(cols), torch.int32, rows.device)
    if not rows.is_cuda:
        if rows.device.type != "cpu":
            raise ValueError(f"hashgrid_table_grad: unsupported device {rows.device}")
        return table_grad_plain(rows, weights, g, col_level, n_rows, C)
    return _table_grad_launch(rows, weights, g, col_level, n_rows, C)


def table_grad_plain(rows, weights, g, col_level, n_rows: int, C: int) -> torch.Tensor:
    """The plain version of the scatter (``index_add_``), on any device:
    ``col_level`` [J] int32 tensor, g [N, L*C] fp32."""
    n = rows.shape[0]
    contrib = weights[..., None] * g.reshape(n, -1, C).index_select(1, col_level)
    d_table = torch.zeros((n_rows, C), dtype=torch.float32, device=rows.device)
    return d_table.index_add_(0, rows.reshape(-1), contrib.reshape(-1, C))


def _table_grad_launch(rows, weights, g, col_level, n_rows: int, C: int):
    """Checks the operands, then launches the kernel."""
    from focnerf_tpu_torch.ops._build import load_library
    from focnerf_tpu_torch.utils.flops import note_kernel_bytes

    n, J = rows.shape
    for name, t, dtype, shape in (
        ("rows", rows, torch.int32, (n, J)),
        ("weights", weights, torch.float32, (n, J)),
        ("g", g, torch.float32, (n, g.shape[-1])),
        ("col_level", col_level, torch.int32, (J,)),
    ):
        _check(name, t, dtype, shape, rows.device)
    if n_rows >= 2**31:
        raise ValueError(f"table of {n_rows} rows: int32 rows need fewer than 2^31")
    if C < 1 or g.shape[-1] % C:
        raise ValueError(f"g: {g.shape[-1]} columns are not whole levels of {C} channels")
    d_table = torch.zeros((n_rows, C), dtype=torch.float32, device=rows.device)
    fn = load_library("hashgrid_bwd").focnerf_hashgrid_table_grad
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    err = fn(
        rows.data_ptr(), weights.data_ptr(), g.data_ptr(), col_level.data_ptr(),
        d_table.data_ptr(), n, J, C, g.shape[1],
        torch.cuda.current_stream(rows.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"table-gradient kernel launch failed: cudaError {err}")
    hashgrid_table_grad.launches += 1
    note_kernel_bytes(3.0 * n * J * C * 4)  # the scatter's read-modify-write, for utils/flops
    return d_table


hashgrid_table_grad.launches = 0


_MAX_LEVELS = 32  # csrc/hashgrid_fwd.cu's kMaxLevels
# csrc/hashgrid_fwd.cu's kernels, by the names a torch.profiler trace shows
ENCODE_KERNEL, INPUT_GRAD_KERNEL = "encode_kernel", "input_grad_kernel"


class _LevelTable(ctypes.Structure):
    """The encode kernels' level table, passed by value (csrc/hashgrid_fwd.cu
    ``LevelTable``, field for field)."""

    _fields_ = [
        ("num_levels", ctypes.c_int),
        ("input_dim", ctypes.c_int),
        ("level_dim", ctypes.c_int),
        ("k", ctypes.c_int),
        ("n_stoch", ctypes.c_int),
        ("total_cols", ctypes.c_int),
        ("inv_k", ctypes.c_float),
        ("scale", ctypes.c_float * _MAX_LEVELS),
        ("offset", ctypes.c_uint32 * _MAX_LEVELS),
        ("mask", ctypes.c_uint32 * _MAX_LEVELS),
        ("res1", ctypes.c_uint32 * _MAX_LEVELS),
        ("hashed", ctypes.c_int * _MAX_LEVELS),
        ("stoch", ctypes.c_int * _MAX_LEVELS),
        ("col", ctypes.c_int * _MAX_LEVELS),
    ]


@functools.lru_cache(maxsize=None)
def level_table(spec: HashGridSpec, stochastic: bool) -> _LevelTable:
    """The kernels' level table of ``spec``: each level's scale (``_level_scale``'s
    fp32), offset, mask (a hashed level's size less 1: the kernels mask the
    hash where the plain version takes it modulo the size, so a hashed
    level's size must be a power of two, as ``HashGridSpec.create`` makes
    every one; 0 on a dense level), R + 1, hashed flag, index on the draws'
    axis 1 (-1: exact; every level is exact unless ``stochastic``) and first
    residual column (``col_levels``' order)."""
    L = spec.num_levels
    if not 1 <= L <= _MAX_LEVELS or not 1 <= spec.input_dim <= len(_PRIMES) or not 1 <= spec.level_dim <= 8:
        raise ValueError(f"encode kernel: {L} levels (at most {_MAX_LEVELS}), input_dim {spec.input_dim} "
                         f"(at most {len(_PRIMES)}), level_dim {spec.level_dim} (at most 8)")
    if spec.table_rows >= 2**31:
        raise ValueError(f"table of {spec.table_rows} rows: int32 rows need fewer than 2^31")
    stoch = stochastic_levels(spec) if stochastic else ()
    cols = col_levels(spec, stochastic)
    K = spec.stochastic_k
    lt = _LevelTable(num_levels=L, input_dim=spec.input_dim, level_dim=spec.level_dim, k=max(K, 0),
                     n_stoch=len(stoch), total_cols=len(cols), inv_k=float(np.float32(1.0 / K)) if K > 0 else 0.0)
    for lvl in range(L):
        lt.scale[lvl] = _level_scale(spec, lvl)
        lt.offset[lvl] = spec.offsets[lvl]
        size = spec.level_size(lvl)
        if spec.hashed[lvl] and size & (size - 1):
            raise ValueError(f"encode kernel: hashed level {lvl} has {size} rows, not a power of two")
        lt.mask[lvl] = size - 1 if spec.hashed[lvl] else 0
        lt.res1[lvl] = spec.resolutions[lvl] + 1
        lt.hashed[lvl] = int(spec.hashed[lvl])
        lt.stoch[lvl] = stoch.index(lvl) if lvl in stoch else -1
        lt.col[lvl] = cols.index(lvl)
    return lt


class _Tile(ctypes.Structure):
    """A block's tile and its shared-memory layout, passed by value
    (csrc/hashgrid_fwd.cu ``Tile``, field for field): strides in words
    between consecutive points' rows, offsets in words (x's tile at 0)."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "points", "warps", "smem_bytes", "x_stride", "u_stride", "cols_stride", "res_stride", "res_levels",
        "u_off", "cols_off", "rows_off", "weights_off", "terms_off")]


SMEM_LIMIT = 232448  # 227 KB: a block's most dynamic shared memory on sm_90
# An H100 SM: 228 KB of shared memory (1 KB of it reserved a block), 64K
# registers (a warp's taken in units of 256), 64 warps, 32 blocks.
SM_SMEM, SM_BLOCK_SMEM, SM_REGS, SM_WARPS, SM_BLOCKS = 233472, 1024, 65536, 64, 32
# The shared memory the blocks resident on an SM may take between them: the
# rest of the SM's 256 KB is L1, where the coarse levels' gathers hit. On
# the card the fastest tile of each of the seven shapes swept (PERF.md, PR
# 18) kept 97-174 KB; tiles at 184-230 KB ran up to 2x slower.
SM_SMEM_TARGET = 180224  # 176 KB
TILE_POINTS = (128, 96, 64, 32)
TILE_WARPS = (8, 4, 2, 1)  # csrc/hashgrid_fwd.cu's kMaxWarps is the first


def _odd(words: int) -> int:
    """A row stride of at least ``words``, odd: a warp reading one column of
    32 rows hits 32 banks."""
    return words | 1


def _seg(words: int) -> int:
    """Words a tile takes, rounded up to 16 bytes."""
    return -(-words // 4) * 4


def _layout(P: int, D: int, L: int, C: int, ulen: int, res_cols: int, res_levels: int, terms: bool,
            warps: int) -> _Tile:
    """Tiles x [P, D], u [P, ulen], the [P, L*C] columns, rows and weights
    [P, res_cols] (0: none), the residual columns of ``res_levels`` levels,
    and the level terms [L, D, P] (``terms``), one after another, each at a
    16-byte offset."""
    xs, us, cs, rs = _odd(D), _odd(ulen) if ulen else 0, _odd(L * C), _odd(res_cols) if res_cols else 0
    offs, off = [], _seg(P * xs)
    for words in (P * us, P * cs, P * rs, P * rs, L * D * P if terms else 0):
        offs.append(off)
        off += _seg(words)
    u_off, cols_off, rows_off, weights_off, terms_off = offs
    return _Tile(points=P, warps=warps, smem_bytes=off * 4, x_stride=xs, u_stride=us, cols_stride=cs,
                 res_stride=rs, res_levels=res_levels, u_off=u_off, cols_off=cols_off, rows_off=rows_off,
                 weights_off=weights_off, terms_off=terms_off)


def resident_blocks(tile: _Tile, regs: int) -> int:
    """Blocks of ``tile`` an SM holds at once, each thread taking ``regs``
    registers."""
    warp_regs = -(-regs * 32 // 256) * 256
    return min(SM_BLOCKS, SM_WARPS // tile.warps, SM_REGS // (warp_regs * tile.warps),
               SM_SMEM // (tile.smem_bytes + SM_BLOCK_SMEM))


def _best(tiles, regs: int) -> _Tile:
    """Of ``tiles`` (each chunk's items a multiple of its warps), those
    whose resident blocks leave L1 its share (``SM_SMEM_TARGET``) and hold
    within 15% of the most warps any of them does; of these the one with
    the most (point, level) items a chunk, then the most points, then the
    most warps (on the card, tiles of fewer points ran slower at the same
    occupancy: each block's copies in and out do no gathers). Else the one
    of least shared memory. Within ``SMEM_LIMIT`` either way."""
    tiles = [t for t in tiles if t.smem_bytes <= SMEM_LIMIT]
    if not tiles:
        raise ValueError(f"encode kernels: no tile fits a block's {SMEM_LIMIT} B of shared memory")
    fits = [t for t in tiles if 0 < resident_blocks(t, regs) * (t.smem_bytes + SM_BLOCK_SMEM) <= SM_SMEM_TARGET]
    if not fits:
        return min(tiles, key=lambda t: (t.smem_bytes, -t.warps))
    most = max(resident_blocks(t, regs) * t.warps for t in fits)
    pool = [t for t in fits if resident_blocks(t, regs) * t.warps >= 0.85 * most]
    return max(pool, key=lambda t: (t.points * t.res_levels, t.points, t.warps))


def _warps(items: int):
    """The block sizes whose warps share ``items`` evenly."""
    return [w for w in TILE_WARPS if items % w == 0]


@functools.lru_cache(maxsize=None)
def encode_tile(L: int, D: int, C: int, ulen: int, level_cols: int, residuals: bool, regs: int) -> _Tile:
    """The encode kernel's tile, for a kernel of ``regs`` registers a thread:
    P points (``TILE_POINTS``), their x, draws (``ulen`` floats a point) and
    out, and with ``residuals`` the rows and weights of a chunk of levels at
    a time (``level_cols`` columns a level at the most; the levels cut into
    chunks of equal size, the last one less), with warps that share each
    chunk's (32-point group, level) items evenly; the best by ``_best``."""
    chunks = sorted({-(-L // m) for m in range(1, L + 1)}, reverse=True) if residuals else [L]
    return _best([_layout(P, D, L, C, ulen, k * level_cols if residuals else 0, k, False, w)
                  for k in chunks for P in TILE_POINTS for w in _warps(P // 32 * k)], regs)


@functools.lru_cache(maxsize=None)
def input_grad_tile(L: int, D: int, C: int, regs: int) -> _Tile:
    """The position-gradient kernel's tile, for a kernel of ``regs``
    registers a thread: P points, their x and cotangent and the level terms,
    with warps that share the (32-point group, level) items evenly; the best
    by ``_best``."""
    return _best([_layout(P, D, L, C, 0, 0, L, True, w) for P in TILE_POINTS for w in _warps(P // 32 * L)],
                 regs)


@functools.lru_cache(maxsize=None)
def kernel_regs(kernel: str, D: int) -> int:
    """Registers a thread of the built ``encode`` or ``input_grad`` kernel
    for input_dim D uses (``cudaFuncGetAttributes``)."""
    from focnerf_tpu_torch.ops._build import load_library

    fn = load_library("hashgrid_fwd").focnerf_hashgrid_kernel_regs
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    regs = fn({"encode": 0, "input_grad": 1}[kernel], D)
    if regs <= 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed for the {kernel} kernel at D = {D}")
    return regs


def spec_encode_tile(spec: HashGridSpec, stochastic: bool, residuals: bool, regs: int) -> _Tile:
    """``encode_tile`` of ``spec``'s encode (``stochastic``: with draws)."""
    lt = level_table(spec, stochastic)
    D = spec.input_dim
    level_cols = max(lt.k if lt.stoch[lvl] >= 0 else 1 << D for lvl in range(spec.num_levels))
    return encode_tile(spec.num_levels, D, spec.level_dim, lt.n_stoch * lt.k * D, level_cols, residuals, regs)


def _check_table(table: torch.Tensor, spec: HashGridSpec):
    if table.dtype != torch.float32 or not table.is_contiguous() or table.dim() != 2 \
            or table.shape[0] < spec.table_rows or table.shape[1] != spec.level_dim:
        raise ValueError(f"table: need a contiguous float32 [>= {spec.table_rows}, {spec.level_dim}], got "
                         f"{table.dtype} {tuple(table.shape)}")
    if spec.level_dim == 2 and table.data_ptr() % 8:
        raise ValueError("table: two-channel rows must be 8-byte aligned (the kernels' float2 loads)")


def _encode_launch(table, x01, spec: HashGridSpec, u, residuals: bool):
    """Checks the operands, then launches ``focnerf_hashgrid_encode`` on the
    current stream."""
    from focnerf_tpu_torch.ops._build import load_library
    from focnerf_tpu_torch.utils.flops import note_kernel_bytes

    device = table.device
    D, L, C = spec.input_dim, spec.num_levels, spec.level_dim
    x = x01.reshape(-1, D).float().contiguous()
    n = x.shape[0]
    stoch = stochastic_levels(spec) if u is not None else ()
    _check_table(table, spec)
    _check("x01", x, torch.float32, (n, D), device)
    if stoch:
        _check("u", u, torch.float32, (n, len(stoch), spec.stochastic_k, D), device)
    lt = level_table(spec, u is not None)
    tile = spec_encode_tile(spec, u is not None, residuals, kernel_regs("encode", D))
    out = torch.empty((n, L * C), dtype=torch.float32, device=device)
    rows = weights = None
    if residuals:
        rows = torch.empty((n, lt.total_cols), dtype=torch.int32, device=device)
        weights = torch.empty((n, lt.total_cols), dtype=torch.float32, device=device)
    fn = load_library("hashgrid_fwd").focnerf_hashgrid_encode
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [_LevelTable, _Tile, ctypes.c_longlong] + [ctypes.c_void_p] * 4
    err = fn(table.data_ptr(), x.data_ptr(), u.data_ptr() if stoch else None, lt, tile, n, out.data_ptr(),
             None if rows is None else rows.data_ptr(), None if weights is None else weights.data_ptr(),
             torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"encode kernel launch failed: cudaError {err}")
    hashgrid_encode_forward.launches += 1
    note_kernel_bytes(2.0 * n * lt.total_cols * C * 4)  # its table gathers, as utils/flops counts a gather
    return out, rows, weights


def _input_grad_launch(table, x01, g, spec: HashGridSpec):
    """Checks the operands, then launches ``focnerf_hashgrid_input_grad`` on
    the current stream."""
    from focnerf_tpu_torch.ops._build import load_library
    from focnerf_tpu_torch.utils.flops import note_kernel_bytes

    device = table.device
    D, L, C = spec.input_dim, spec.num_levels, spec.level_dim
    x = x01.detach().reshape(-1, D).float().contiguous()
    n = x.shape[0]
    g = g.reshape(n, -1).float().contiguous()
    _check_table(table, spec)
    _check("x01", x, torch.float32, (n, D), device)
    _check("g", g, torch.float32, (n, L * C), device)
    lt = level_table(spec, False)
    tile = input_grad_tile(L, D, C, kernel_regs("input_grad", D))
    gx = torch.empty((n, D), dtype=torch.float32, device=device)
    fn = load_library("hashgrid_fwd").focnerf_hashgrid_input_grad
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [_LevelTable, _Tile, ctypes.c_longlong] + [ctypes.c_void_p] * 2
    err = fn(table.data_ptr(), x.data_ptr(), g.data_ptr(), lt, tile, n, gx.data_ptr(),
             torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"position-gradient kernel launch failed: cudaError {err}")
    hashgrid_input_grad.launches += 1
    note_kernel_bytes(2.0 * n * (L << D) * C * 4)  # its table gathers, as utils/flops counts a gather
    return gx.reshape(x01.shape)
