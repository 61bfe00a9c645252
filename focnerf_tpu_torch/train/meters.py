"""Evaluation metrics: PSNR and SSIM.

Twin of focnerf_tpu/train/meters.py (PSNRMeter, SSIMMeter; nerf/utils.py
:545-621). SSIM's separable Gaussian is two banded-matrix products in fp32,
as in the JAX package. LPIPS (weight-gated there) and MS-SSIM are not
ported.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def psnr(pred: torch.Tensor, gt: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    mse = ((pred.float() - gt.float()) ** 2).mean()
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-20) / (max_val**2))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x**2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _band_matrix(n_in: int, size: int, sigma: float) -> np.ndarray:
    """[n_in-size+1, n_in] Toeplitz matrix applying the VALID 1-D Gaussian."""
    k = _gaussian_kernel(size, sigma)
    n_out = n_in - size + 1
    B = np.zeros((n_out, n_in), np.float32)
    for j in range(size):
        B[np.arange(n_out), np.arange(n_out) + j] = k[j]
    return B


def ssim(pred: torch.Tensor, gt: torch.Tensor, max_val: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Mean structural similarity of [H, W, C] (or [B, H, W, C]) images."""
    if pred.dim() == 3:
        pred, gt = pred[None], gt[None]
    pred, gt = pred.float(), gt.float()
    Bh = torch.from_numpy(_band_matrix(pred.shape[1], kernel_size, sigma)).to(pred.device)
    Bw = torch.from_numpy(_band_matrix(pred.shape[2], kernel_size, sigma)).to(pred.device)

    def filt(img):
        return torch.einsum("pw,bowc->bopc", Bw, torch.einsum("oh,bhwc->bowc", Bh, img))

    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu_p, mu_g = filt(pred), filt(gt)
    mu_p2, mu_g2, mu_pg = mu_p**2, mu_g**2, mu_p * mu_g
    sig_p = filt(pred**2) - mu_p2
    sig_g = filt(gt**2) - mu_g2
    sig_pg = filt(pred * gt) - mu_pg
    cs = (2 * sig_pg + c2) / (sig_p + sig_g + c2)
    lum = (2 * mu_pg + c1) / (mu_p2 + mu_g2 + c1)
    return (lum * cs).mean()


class Meter:
    """Accumulating scalar meter with the reference's measure/report API."""

    def __init__(self, name: str, fn):
        self.name = name
        self._fn = fn
        self.clear()

    def clear(self):
        self.vals = []

    def update(self, pred, gt):
        self.vals.append(float(self._fn(pred, gt)))

    def measure(self) -> float:
        return float(np.mean(self.vals)) if self.vals else 0.0

    def report(self) -> str:
        return f"{self.name} = {self.measure():.6f}"


def PSNRMeter() -> Meter:
    return Meter("PSNR", psnr)


def SSIMMeter() -> Meter:
    return Meter("SSIM", ssim)
