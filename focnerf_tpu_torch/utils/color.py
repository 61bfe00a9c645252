"""Color-space conversions; twin of focnerf_tpu/utils/color.py (nerf/utils.py:46-53)."""

import torch


def linear_to_srgb(x):
    return torch.where(x < 0.0031308, 12.92 * x, 1.055 * x.clamp(min=0) ** (1 / 2.4) - 0.055)


def srgb_to_linear(x):
    return torch.where(x < 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)
