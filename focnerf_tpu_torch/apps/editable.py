"""Scene editing CLI: composition with a rigid move of one object.

Twin of focnerf_tpu/apps/editable.py (the reference's editable.py): the
composition flow of ``apps/combined.py`` plus

  - ``--edit_object`` with ``--offset_x/y/z`` (:76-79): the edited object's
    ray origins are shifted by the offset (modify_rays_for_object
    :443-471), a rigid translation inside the composed scene, and with
    ``--rotate_x/y/z`` a rotation in degrees (x, then y, then z) about the
    origin of its field, before the translation. Per sample, a rotation
    voids the union occupancy bitfield, so sampling is uniform; with
    ``--baked`` the object's volume is rotated and shifted before the merge
    (render/baked.py), and the frames stay on the shear-warp path;
  - pose-distance-weighted features per view (calculate_feats2_inference,
    :781) instead of the plain average;
  - ``composite.mp4`` of the composited frames (:405-418), or its PNG frames
    where no mp4 writer exists.

The edited object is named by its workspace directory (``<ws>_<obj>``), so
any class works.

Usage:
  python -m focnerf_tpu_torch.apps.editable <scene> --ckpt_dir <dir> \\
      --edit_object cup --offset_x 0.2 --workspace edit_ws [--baked --rotate_z 90]
"""

from __future__ import annotations

import os

import numpy as np

from focnerf_tpu_torch import resolve_device
from focnerf_tpu_torch.config import parse_options


def main(argv=None, device=None):
    """CLI entry; ``device`` None means ``cuda`` (raises without CUDA).
    Returns the edited frames."""
    opt = parse_options(argv)
    device = resolve_device(device)
    os.makedirs(opt.workspace, exist_ok=True)

    from focnerf_tpu_torch.apps.combined import discover_objects, evaluate_composition

    objs = discover_objects(opt)
    offsets = np.zeros((len(objs), 3), np.float32)
    rotations = np.zeros((len(objs), 3), np.float32)
    if opt.edit_object:
        if opt.edit_object not in objs:
            raise SystemExit(f"--edit_object {opt.edit_object!r} not among composed objects {objs}")
        k = objs.index(opt.edit_object)
        offsets[k] = [opt.offset_x, opt.offset_y, opt.offset_z]
        print(f"[editable] translating {opt.edit_object} by {offsets[k]}")
        rotations[k] = [opt.rotate_x, opt.rotate_y, opt.rotate_z]
        if rotations[k].any():
            print(f"[editable] rotating {opt.edit_object} by {rotations[k]} deg")

    frames = evaluate_composition(opt, offsets=offsets, write_video=True, feats_mode="pose",
                                  rotations=rotations, device=device)
    print(f"[editable] rendered {len(frames)} edited frames into {opt.workspace}")
    return frames


if __name__ == "__main__":
    main()
