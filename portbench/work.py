"""The work the rooflines and MFU divide by: model FLOPs from the
configuration's widths, an op's bytes from its shapes, and the card's peaks.

Counted from the configuration and the shapes only, so the numbers are the
same whatever kernel does the work.
"""

from __future__ import annotations

from portbench.common import mlp_dims

# One NVIDIA H100 SXM5 (NVIDIA's data sheet; dense rates, 700 W): the bf16
# tensor-core rate (the -O MLPs' precision) and the HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def macs_per_sample(config: dict) -> int:
    """Multiply-adds of the sigma and colour MLPs at one sample point."""
    dims = mlp_dims(config)
    return sum(a * b for name in ("sigma_net", "color_net") for a, b in zip(dims[name][:-1], dims[name][1:]))


def forward_flops_per_sample(config: dict) -> int:
    return 2 * macs_per_sample(config)


def train_flops_per_sample(config: dict) -> int:
    """Forward and backward (the backward's two products per layer): 3x."""
    return 3 * forward_flops_per_sample(config)


def encode_bytes(n_points: int, config: dict) -> int:
    """The exact encode's inputs and outputs: points [n, 3] fp32 in, features
    [n, L*C] fp32 out. The table rows it reads are data-dependent and not
    counted, so the least time is a lower bound."""
    return n_points * 3 * 4 + n_points * config["num_levels"] * config["level_dim"] * 4


def table_grad_bytes(n_points: int, config: dict) -> int:
    """The table gradient's scatter under -O (one stochastic corner a
    level): rows [n, L] int32 and weights [n, L] fp32 and the cotangent
    [n, L*C] fp32 read once. The zero fill of the gradient table is its own
    kernel and is not counted here."""
    L, C = config["num_levels"], config["level_dim"]
    cols = L * config["stochastic_corners"]
    return n_points * cols * 4 * 2 + n_points * L * C * 4


def roofline_pct(n_bytes: float, flops: float, seconds: float) -> float:
    least = max(n_bytes / PEAK_HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)
    return 100.0 * least / seconds
