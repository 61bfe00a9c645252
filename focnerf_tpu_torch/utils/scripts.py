"""One-off data utilities (nerf/create_video.py, generate_video.py,
load_jason.py and rearrange_transformjson.py of the reference).

Twin of focnerf_tpu/utils/scripts.py:

  - ``folder_to_video``: the PNG/JPG frames of a folder, in numeric order,
    into one mp4 through ``utils/video.write_video`` (read by
    ``data/png.read_image``);
  - ``sort_transforms``: a transforms.json's frames ordered by file_path,
    numbers compared as numbers.
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional


def _numeric_key(name: str):
    nums = re.findall(r"\d+", name)
    return (int(nums[-1]) if nums else 0, name)


def folder_to_video(folder: str, out_path: Optional[str] = None, fps: int = 25) -> str:
    """All PNG/JPG frames in ``folder`` (numeric order) -> one mp4 (or,
    where no mp4 writer exists, ``write_video``'s numbered PNGs beside it)."""
    from focnerf_tpu_torch.data.png import read_image
    from focnerf_tpu_torch.utils.video import write_video

    names = sorted((n for n in os.listdir(folder) if n.lower().endswith((".png", ".jpg", ".jpeg"))),
                   key=_numeric_key)
    frames = [read_image(os.path.join(folder, n))[..., :3] for n in names]
    out_path = out_path or os.path.join(folder, "video.mp4")
    write_video(out_path, frames, fps=fps)
    return out_path


def sort_transforms(path: str, out_path: Optional[str] = None) -> str:
    """Sort a transforms.json's frames by file_path (numeric-aware)."""
    with open(path) as f:
        data = json.load(f)
    data["frames"] = sorted(data["frames"], key=lambda fr: _numeric_key(fr["file_path"]))
    out_path = out_path or path
    with open(out_path, "w") as f:
        json.dump(data, f, indent=2)
    return out_path
