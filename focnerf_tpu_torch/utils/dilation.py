"""Mask dilation (nerf/dilations.py of the reference).

Twin of focnerf_tpu/utils/dilation.py: grow a boolean object mask by 3x3
dilations until its area has grown by a target percentage. numpy only.
"""

from __future__ import annotations

import numpy as np


def _dilate_once(mask: np.ndarray) -> np.ndarray:
    """3x3 binary dilation."""
    out = mask.copy()
    out[1:, :] |= mask[:-1, :]
    out[:-1, :] |= mask[1:, :]
    out[:, 1:] |= mask[:, :-1]
    out[:, :-1] |= mask[:, 1:]
    out[1:, 1:] |= mask[:-1, :-1]
    out[:-1, :-1] |= mask[1:, 1:]
    out[1:, :-1] |= mask[:-1, 1:]
    out[:-1, 1:] |= mask[1:, :-1]
    return out


def increase_dilation_percentage(mask: np.ndarray, target_percent: float, max_iters: int = 100) -> np.ndarray:
    """Dilate until the area grows by >= ``target_percent`` of the original
    (an empty mask counts as area 1), or stops growing."""
    mask = np.asarray(mask, bool)
    target = max(int(mask.sum()), 1) * (1.0 + target_percent / 100.0)
    out = mask
    for _ in range(max_iters):
        if out.sum() >= target:
            break
        grown = _dilate_once(out)
        if grown.sum() == out.sum():  # saturated
            break
        out = grown
    return out
