"""Classic NeRF frequency (positional) encoding.

Twin of focnerf_tpu/ops/freq.py: ``[x, sin(2^0 x), cos(2^0 x), ...,
sin(2^{deg-1} x), cos(2^{deg-1} x)]``, output dim ``D + 2 * D * degree``.
The D-NeRF fields encode positions (degree 10) and times (degree 6) with it.
"""

import torch


def freq_encode(x: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """x [..., D] -> [..., D * (1 + 2 * degree)]."""
    outs = [x]
    for f in range(degree):
        xf = x * (2.0**f)
        outs.append(torch.sin(xf))
        outs.append(torch.cos(xf))
    return torch.cat(outs, dim=-1)


def freq_output_dim(input_dim: int, degree: int) -> int:
    return input_dim + 2 * input_dim * degree
