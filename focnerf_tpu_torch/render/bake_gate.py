"""Per-object bake-vs-exact quality gate.

Twin of focnerf_tpu/render/bake_gate.py. The baked shear-warp path
approximates the trained field, so its PSNR cost is measured at every bake:
a few probe views render through the exact per-sample path
(``render/renderer.py::render_image``, whose compositing runs in the CUDA
forward kernel on the card) and through the baked volume
(``render/baked.py::render_baked``), and the result is written to
``<workspace>/bake_quality.json``.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float(10.0 * np.log10(1.0 / max(mse, 1e-12)))


def _probe(poses, intrinsics, H: int, W: int, n_views: int, probe_max_res: int):
    """(probe view indices, h, w, scaled intrinsics): at most
    ``probe_max_res`` on a side (the gate measures representation error,
    which does not depend on the resolution)."""
    s = min(1.0, probe_max_res / max(H, W))
    h, w = max(8, int(round(H * s))), max(8, int(round(W * s)))
    fx, fy, cx, cy = intrinsics
    take = np.linspace(0, len(poses) - 1, min(n_views, len(poses))).astype(int)
    return take, h, w, (fx * s, fy * s, cx * s, cy * s)


def _host(img) -> np.ndarray:
    return np.clip(img.detach().cpu().numpy(), 0, 1)


def _write(report: dict, out_path: Optional[str]) -> dict:
    if out_path is not None:
        if os.path.dirname(out_path):
            os.makedirs(os.path.dirname(out_path), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
    return report


def _summary(psnrs, key: str) -> dict:
    return {
        f"{key}_mean": round(float(np.mean(psnrs)), 3) if psnrs else None,
        f"{key}_min": round(float(np.min(psnrs)), 3) if psnrs else None,
    }


def bake_quality_report(
    params,
    cfg,
    vol,
    poses,
    intrinsics,
    H: int,
    W: int,
    *,
    obj_feat=None,
    occ_bits=None,
    num_steps: int = 256,
    n_views: int = 3,
    probe_max_res: int = 200,
    out_path: Optional[str] = None,
) -> dict:
    """PSNR of the baked volume against the exact field on probe views
    (spread over ``poses``); a pose whose eye is inside the volume cube is
    skipped. Returns the report, and writes it to ``out_path``."""
    from focnerf_tpu_torch.render.baked import render_baked
    from focnerf_tpu_torch.render.renderer import render_image

    poses = np.asarray(poses)
    take, h, w, intr = _probe(poses, intrinsics, H, W, n_views, probe_max_res)
    rows = []
    for vi in take:
        exact_img, _ = render_image(
            params, cfg, poses[vi], intr, h, w, num_steps=num_steps, bg_color=1.0,
            obj_feat=obj_feat, occ_bits=occ_bits,
        )
        try:
            img_b, _, _ = render_baked(vol, poses[vi], intr, h, w, bg_color=1.0,
                                       density_scale=getattr(cfg, "density_scale", 1.0))
        except ValueError:  # camera inside the volume: shear-warp undefined
            continue
        rows.append({"view": int(vi), "psnr_baked_vs_exact": round(_psnr(_host(img_b), _host(exact_img)), 3)})

    psnrs = [r["psnr_baked_vs_exact"] for r in rows]
    return _write({
        "bake_resolution": int(vol.rgba.shape[0]),
        "sh_deg": int(vol.sh_deg),
        "probe_hw": [h, w],
        "exact_num_steps": int(num_steps),
        "views": len(rows),
        **_summary(psnrs, "psnr_baked_vs_exact"),
        "per_view": rows,
    }, out_path)


def volume_quantization_report(
    vol_float,
    vol_quant,
    poses,
    intrinsics,
    H: int,
    W: int,
    *,
    n_views: int = 3,
    probe_max_res: int = 200,
    density_scale: float = 1.0,
    out_path: Optional[str] = None,
) -> dict:
    """PSNR cost of uint8 quantization (--bake_quantize) on probe views: the
    float volume's render against the quantized volume's."""
    from focnerf_tpu_torch.render.baked import render_baked

    poses = np.asarray(poses)
    take, h, w, intr = _probe(poses, intrinsics, H, W, n_views, probe_max_res)
    rows = []
    for vi in take:
        try:
            f_img, _, _ = render_baked(vol_float, poses[vi], intr, h, w, bg_color=1.0,
                                       density_scale=density_scale)
            q_img, _, _ = render_baked(vol_quant, poses[vi], intr, h, w, bg_color=1.0,
                                       density_scale=density_scale)
        except ValueError:
            continue
        rows.append({"view": int(vi), "psnr_quantized_vs_float": round(_psnr(_host(q_img), _host(f_img)), 3)})

    psnrs = [r["psnr_quantized_vs_float"] for r in rows]
    return _write({
        "bake_resolution": int(vol_float.rgba.shape[0]),
        "sh_deg": int(vol_float.sh_deg),
        "probe_hw": [h, w],
        "views": len(rows),
        **_summary(psnrs, "psnr_quantized_vs_float"),
        "per_view": rows,
    }, out_path)
