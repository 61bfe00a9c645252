"""Loss functions (loss.py of the reference).

Twin of focnerf_tpu/train/loss.py:

  - ``mape_loss`` (loss.py:7): |pred - gt| / (|gt| + eps), mean or per element;
  - ``huber_loss`` (loss.py:18): smooth-L1 with threshold ``delta``;
  - ``eff_distloss`` (loss.py:30-76): the O(N) mip-NeRF-360 distortion loss
    by prefix sums; autograd differentiates it (the reference hand-writes
    the backward).

The active training loss lives in train/steps.py.
"""

from __future__ import annotations

import torch


def mape_loss(pred, target, eps: float = 1e-2, reduction: str = "mean"):
    """Mean absolute percentage error (loss.py:7-15)."""
    diff = (pred - target).abs() / (target.abs() + eps)
    return diff.mean() if reduction == "mean" else diff


def huber_loss(pred, target, delta: float = 0.1, reduction: str = "mean"):
    """Smooth-L1 (loss.py:18-27)."""
    err = (pred - target).abs()
    loss = torch.where(err < delta, 0.5 * err**2 / delta, err - 0.5 * delta)
    return loss.mean() if reduction == "mean" else loss


def eff_distloss(weights, midpoints, intervals):
    """Distortion loss sum_ij w_i w_j |m_i - m_j| + (1/3) sum_i w_i^2 d_i
    (Sun et al. 2022), by prefix sums, averaged over the leading dims.

    weights, midpoints (increasing), intervals: [..., T].
    """
    wm = weights * midpoints

    def exclusive(c):  # the prefix sums before each sample
        return torch.cat([torch.zeros_like(c[..., :1]), c[..., :-1]], -1)

    w_prev = exclusive(torch.cumsum(weights, -1))
    wm_prev = exclusive(torch.cumsum(wm, -1))
    pair = 2.0 * (wm * w_prev - weights * wm_prev).sum(-1)
    self_term = (weights**2 * intervals).sum(-1) / 3.0
    return (pair + self_term).mean()
