"""Evaluation metrics: PSNR, SSIM, MS-SSIM and LPIPS (or its substitute).

Twin of focnerf_tpu/train/meters.py (PSNRMeter, SSIMMeter, LPIPSMeter;
nerf/utils.py:545-658). SSIM's separable Gaussian is two banded-matrix
products in fp32, as in the JAX package; MS-SSIM is its dyadic pyramid.

Meters take [H, W, C] images in [0, 1], as numpy arrays or torch tensors on
any device: a render on the card is measured on the card, and only the
scalar comes back to the host.

``LPIPSMeter`` looks where the JAX package does, in its order: the npz
weights read by train/lpips_npz.py (the twin of focnerf_tpu/train/
lpips_jax.py; the meter is then ``LPIPS (alex, torch)``), then the torch
``lpips`` package, else the weight-free substitute ``1 - ms_ssim``,
labelled ``LPIPS* (ms-ssim-dist)``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _as_pair(pred, gt):
    """(pred, gt) as float32 tensors on pred's device (numpy -> CPU)."""
    pred = torch.as_tensor(pred)
    gt = torch.as_tensor(gt, device=pred.device)
    return pred.float(), gt.float()


def psnr(pred, gt, max_val: float = 1.0) -> torch.Tensor:
    pred, gt = _as_pair(pred, gt)
    mse = ((pred - gt) ** 2).mean()
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


def _ssim_parts(pred, gt, max_val: float = 1.0, kernel_size: int = 11, sigma: float = 1.5):
    """Single-scale SSIM of [H, W, C] (or [B, H, W, C]) images -> (mean full
    index, mean contrast/structure term); the second feeds ``ms_ssim``."""
    pred, gt = _as_pair(pred, gt)
    if pred.dim() == 3:
        pred, gt = pred[None], gt[None]
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
    return (lum * cs).mean(), cs.mean()


def ssim(pred, gt, max_val: float = 1.0, kernel_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Mean structural similarity of [H, W, C] (or [B, H, W, C]) images."""
    return _ssim_parts(pred, gt, max_val, kernel_size, sigma)[0]


_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)  # Wang et al. 2003


def _pool2(img: torch.Tensor) -> torch.Tensor:
    """2x2 average pool over H, W of [B, H, W, C]."""
    img = img[:, : img.shape[1] // 2 * 2, : img.shape[2] // 2 * 2]
    return 0.25 * (img[:, 0::2, 0::2] + img[:, 1::2, 0::2] + img[:, 0::2, 1::2] + img[:, 1::2, 1::2])


def ms_ssim(pred, gt, max_val: float = 1.0, kernel_size: int = 11) -> torch.Tensor:
    """Multi-scale SSIM: contrast/structure over a dyadic pyramid, luminance
    at the coarsest scale. Scales shrink for small images (each needs
    ``kernel_size`` valid pixels after pooling); the weights renormalize."""
    pred, gt = _as_pair(pred, gt)
    if pred.dim() == 3:
        pred, gt = pred[None], gt[None]
    side = min(pred.shape[1], pred.shape[2])
    n_scales = 1
    while n_scales < 5 and side // 2 >= kernel_size:
        n_scales += 1
        side //= 2
    w = np.asarray(_MSSSIM_WEIGHTS[:n_scales])
    w = w / w.sum()
    out = torch.ones((), device=pred.device)
    for s in range(n_scales):
        full, cs = _ssim_parts(pred, gt, max_val, kernel_size)
        # cs can dip below 0 on adversarial inputs: clamp so the power is real
        if s == n_scales - 1:
            out = out * torch.clamp(full, min=1e-6) ** float(w[s])
        else:
            out = out * torch.clamp(cs, min=1e-6) ** float(w[s])
            pred, gt = _pool2(pred), _pool2(gt)
    return out


def rgba_ssim(pred_rgba, gt_rgba) -> float:
    """SSIM over RGBA images, channels averaged (COMBINED.py:295-332)."""
    return float(ssim(pred_rgba, gt_rgba))


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


class LPIPSMeter(Meter):
    """LPIPS-alex from the npz weights of train/lpips_npz.py when a file is
    found, else through the torch ``lpips`` package, else ``1 - ms_ssim``
    under the name ``LPIPS* (ms-ssim-dist)`` (lower is better, as LPIPS), so
    a log never passes the substitute off as the real metric."""

    def __init__(self, net: str = "alex"):
        self._net = None
        npz = None
        if net == "alex":
            from focnerf_tpu_torch.train.lpips_npz import try_create

            npz = try_create()
        if npz is not None:
            self.available = True
            super().__init__(f"LPIPS ({net}, torch)", npz)
            return
        try:  # pragma: no cover - depends on an optional package
            import lpips

            self._net = lpips.LPIPS(net=net).eval()
            self.available = True
            super().__init__(f"LPIPS ({net})", self._lpips)
        except Exception:
            self.available = False
            super().__init__("LPIPS* (ms-ssim-dist)", lambda p, g: 1.0 - ms_ssim(p, g))

    def _lpips(self, pred, gt):  # pragma: no cover - depends on an optional package
        pred, gt = _as_pair(pred, gt)
        net = self._net.to(pred.device)
        to = lambda x: x.permute(2, 0, 1)[None] * 2 - 1  # noqa: E731
        with torch.no_grad():
            return net(to(pred), to(gt))
