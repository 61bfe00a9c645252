"""LPIPS (AlexNet backbone) from a weights npz, in plain PyTorch.

Twin of focnerf_tpu/train/lpips_jax.py. The reference measures LPIPS-alex
per eval view (nerf/utils.py:624-658, COMBINED.py:255-264) through the
``lpips`` package; without it and without pretrained weights ``LPIPSMeter``
substitutes a labelled MS-SSIM distance. The moment a weights file lands on
disk this module takes over: the AlexNet feature stack and the LPIPS linear
heads run as ``F.conv2d``/``F.max_pool2d`` on the images' device (library
calls for a network JAX also runs outside any Pallas kernel).

Weights contract (one dump on any machine with torchvision + lpips makes it;
every array in torch's OIHW / [out, in, 1, 1] layout):

    np.savez(path,
        conv0_w=alexnet.features[0].weight,  conv0_b=...[0].bias,
        conv1_w=alexnet.features[3].weight,  conv1_b=...[3].bias,
        conv2_w=alexnet.features[6].weight,  conv2_b=...[6].bias,
        conv3_w=alexnet.features[8].weight,  conv3_b=...[8].bias,
        conv4_w=alexnet.features[10].weight, conv4_b=...[10].bias,
        lin0=lpips_model.lins[0].model[-1].weight, ... lin4=...)

Search order: $FOCNERF_LPIPS_NPZ, then ~/.cache/focnerf/lpips_alex.npz.

The scaling constants are lpips.ScalingLayer's; the metric is, per layer:
unit-normalize the channels, squared difference, the 1x1 conv with the
(non-negative) lin weights, spatial mean; summed over the layers.
"""

from __future__ import annotations

import os
import zipfile
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

# lpips.ScalingLayer: x in [-1, 1] -> (x - shift) / scale
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

_CONV_KEYS = [f"conv{i}_{p}" for i in range(5) for p in ("w", "b")]
_LIN_KEYS = [f"lin{i}" for i in range(5)]
# AlexNet feature-stack geometry: (stride, padding, pool after) per conv
_STRIDES = (4, 1, 1, 1, 1)
_PADS = (2, 2, 1, 1, 1)
_POOL_AFTER = (True, True, False, False, False)


def default_weight_paths():
    env = os.environ.get("FOCNERF_LPIPS_NPZ", "")
    paths = [env] if env else []
    paths.append(os.path.expanduser("~/.cache/focnerf/lpips_alex.npz"))
    return paths


def load_weights(path: Optional[str] = None) -> Optional[Dict[str, torch.Tensor]]:
    """The npz -> dict of float32 CPU tensors, or None if absent or invalid."""
    candidates = [path] if path else default_weight_paths()
    for p in candidates:
        if not (p and os.path.exists(p)):
            continue
        try:
            with np.load(p) as z:
                w = {k: torch.from_numpy(np.asarray(z[k], np.float32)) for k in _CONV_KEYS + _LIN_KEYS}
        except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
            return None
        if tuple(w["conv0_w"].shape) != (64, 3, 11, 11):
            return None
        return w
    return None


def _alexnet_feats(w, x):
    """x: [B, 3, H, W] normalized. Returns the 5 relu feature maps."""
    feats = []
    for i in range(5):
        x = F.relu(F.conv2d(x, w[f"conv{i}_w"], w[f"conv{i}_b"], stride=_STRIDES[i], padding=_PADS[i]))
        feats.append(x)
        if _POOL_AFTER[i]:
            x = F.max_pool2d(x, kernel_size=3, stride=2)
    return feats


def lpips_distance(w, pred, gt) -> torch.Tensor:
    """LPIPS-alex distance between two [H, W, 3] images in [0, 1] (tensors on
    the weights' device) -> a 0-d float32 tensor."""
    shift = torch.as_tensor(_SHIFT, device=pred.device)
    scale = torch.as_tensor(_SCALE, device=pred.device)

    def prep(img):
        x = img.float() * 2.0 - 1.0  # lpips expects [-1, 1]
        return ((x - shift) / scale).permute(2, 0, 1)[None]  # [1, 3, H, W]

    fp = _alexnet_feats(w, prep(pred))
    fg = _alexnet_feats(w, prep(gt))
    total = torch.zeros((), dtype=torch.float32, device=pred.device)
    for i, (a, b) in enumerate(zip(fp, fg)):
        # unit-normalize channel vectors (lpips.normalize_tensor)
        na = a / torch.sqrt(torch.sum(a**2, dim=1, keepdim=True) + 1e-10)
        nb = b / torch.sqrt(torch.sum(b**2, dim=1, keepdim=True) + 1e-10)
        d = (na - nb) ** 2  # [1, C, h, w]
        lin = w[f"lin{i}"].reshape(1, -1, 1, 1)  # [1, C, 1, 1]: the 1x1 conv
        total = total + torch.mean(torch.sum(d * lin, dim=1))
    return total


class NpzLPIPS:
    """Callable (pred, gt) -> float on the images' device: numpy arrays run
    on the CPU, tensors where they lie (the weights are copied there once)."""

    def __init__(self, weights: Dict[str, torch.Tensor]):
        self._w = weights
        self._on = {}  # device -> the weights there

    def weights_on(self, device) -> Dict[str, torch.Tensor]:
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = {k: v.to(device) for k, v in self._w.items()}
        return self._on[device]

    def __call__(self, pred, gt) -> float:
        pred = torch.as_tensor(pred)
        gt = torch.as_tensor(gt, device=pred.device)
        with torch.no_grad():
            return float(lpips_distance(self.weights_on(pred.device), pred, gt))


def try_create(path: Optional[str] = None) -> Optional[NpzLPIPS]:
    w = load_weights(path)
    return NpzLPIPS(w) if w is not None else None
