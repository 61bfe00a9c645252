"""CLIP-guided GT-free training (nerf/clip_utils.py of the reference).

Twin of focnerf_tpu/train/clip_guidance.py. The reference scores renders
from random poses against a text prompt with OpenAI's CLIP (ViT-B/16) when
it trains with ``--rand_pose >= 0`` (nerf/utils.py:796-838). Here the model
is transformers' ``CLIPModel`` (torch), loaded from the local cache only
(``local_files_only``): the repository holds no weights and nothing is
downloaded, so without the package or the weights the loss is unavailable.
The weights are looked up in the local hub cache before transformers is
imported, which takes seconds.

  - ``make_torch_clip_loss`` (JAX's ``make_jax_clip_loss``): a
    differentiable image [H, W, 3] in [0, 1] -> 1 - cos(image embedding,
    text embedding) on the model's device, or None when unavailable. The
    image is transposed to CHW, resized to 224 x 224 as ``jax.image.resize``
    "bilinear" does it (``resize_bilinear``) and normalized by the
    processor's mean and std.
  - ``CLIPLoss``: the same cosine distance as a host-side metric on uint8
    images through the processor.
"""

from __future__ import annotations

import os

import numpy as np
import torch

CLIP_SIZE = 224  # the ViT's input side


def _resize_weights(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """[n_in, n_out] weights of ``jax.image.resize``'s "bilinear" along one
    axis (``compute_weight_mat``, fp32): a triangle kernel at the half-pixel
    source positions, widened by n_in / n_out when the axis shrinks,
    normalized over the inputs it covers, zero for positions outside. The
    source positions are rounded once from (i + 0.5) * inv_scale - 0.5, as
    the fused multiply-add that XLA compiles them to (the fp32 product is
    exact in fp64): so the upsampling weights equal JAX's bit for bit."""
    inv_scale = np.float32(1.0 / (n_out / n_in))
    centre = torch.arange(n_out, dtype=torch.float32, device=device) + 0.5
    sample = (centre.double() * float(inv_scale) - 0.5).float()
    dist = (sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]).abs()
    dist = dist / max(float(inv_scale), 1.0)
    w = torch.clamp(1.0 - dist, min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps), w / torch.where(total != 0, total, 1.0),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_bilinear(x: torch.Tensor, size: int = CLIP_SIZE) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, size, size] as ``jax.image.resize(x, ...,
    "bilinear")``: JAX's weight matrices contracted with the image, which
    interpolate when an axis grows (the rand-pose images: 66 -> 224 at the
    default size) and antialias when it shrinks."""
    wh = _resize_weights(x.shape[-2], size, x.device)
    ww = _resize_weights(x.shape[-1], size, x.device)
    return torch.einsum("bchw,hH,wW->bcHW", x, wh, ww)


def _weights_present(model_name: str) -> bool:
    """Whether ``from_pretrained(model_name, local_files_only=True)`` can find
    the model: a local directory, or its config in the local hub cache. A
    cheap check (importing transformers takes seconds), made without any
    request."""
    if os.path.isdir(model_name):
        return True
    try:
        from huggingface_hub import try_to_load_from_cache
    except ImportError:  # transformers needs it: neither is installed
        return False
    return isinstance(try_to_load_from_cache(model_name, "config.json"), str)


def make_torch_clip_loss(text: str, model_name: str = "openai/clip-vit-base-patch16", device=None):
    """image [H, W, 3] in [0, 1] on ``device`` -> scalar loss, with
    gradients through CLIP into the image; None when ``transformers`` or the
    cached weights are missing. ``device`` None means ``cuda``."""
    from focnerf_tpu_torch import resolve_device

    device = resolve_device(device)
    if not _weights_present(model_name):
        return None
    try:
        from transformers import CLIPModel, CLIPProcessor

        model = CLIPModel.from_pretrained(model_name, local_files_only=True)
        proc = CLIPProcessor.from_pretrained(model_name, local_files_only=True)
    except Exception:  # no package, or no weights in the local cache
        return None
    model = model.to(device).eval().requires_grad_(False)
    with torch.no_grad():
        tok = proc(text=[text], return_tensors="pt", padding=True)
        text_emb = model.get_text_features(**{k: torch.as_tensor(v).to(device) for k, v in tok.items()})
        text_emb = text_emb / text_emb.norm(dim=-1, keepdim=True)
    mean = torch.tensor(proc.image_processor.image_mean, dtype=torch.float32, device=device).reshape(3, 1, 1)
    std = torch.tensor(proc.image_processor.image_std, dtype=torch.float32, device=device).reshape(3, 1, 1)

    def loss(image: torch.Tensor) -> torch.Tensor:
        x = resize_bilinear(image.permute(2, 0, 1)[None])
        emb = model.get_image_features(pixel_values=(x - mean) / std)
        emb = emb / emb.norm(dim=-1, keepdim=True)
        return 1.0 - (emb * text_emb).sum()

    return loss


class CLIPLoss:
    """Text-image alignment as a host-side metric: 1 - cos(text_emb, image_emb)."""

    def __init__(self, text: str, model_name: str = "openai/clip-vit-base-patch16"):
        self.text = text
        self.available = False
        if not _weights_present(model_name):
            self._reason = f"{model_name} is not in the local cache"
            return
        try:
            from transformers import CLIPModel, CLIPProcessor

            self.model = CLIPModel.from_pretrained(model_name, local_files_only=True).eval()
            self.proc = CLIPProcessor.from_pretrained(model_name, local_files_only=True)
        except Exception as e:  # no package, or no weights in the local cache
            self._reason = str(e)
            return
        with torch.no_grad():
            tok = self.proc(text=[text], return_tensors="pt", padding=True)
            emb = self.model.get_text_features(**tok)
            self.text_emb = emb / emb.norm(dim=-1, keepdim=True)
        self.available = True

    def __call__(self, image: np.ndarray) -> float:
        """image [H, W, 3] float in [0, 1] -> the loss (no gradient)."""
        if not self.available:
            raise RuntimeError(f"CLIP weights unavailable offline ({getattr(self, '_reason', '')})")
        with torch.no_grad():
            inp = self.proc(images=[(image * 255).astype(np.uint8)], return_tensors="pt")
            emb = self.model.get_image_features(**inp)
            emb = emb / emb.norm(dim=-1, keepdim=True)
            return float(1.0 - (emb * self.text_emb).sum())
