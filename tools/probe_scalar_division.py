"""How torch's CUDA kernels divide and multiply a tensor by a Python float,
on the card.

The skip-walk kernel (``csrc/march_skip.cu``) must reproduce the plain
walk's ``x / c`` bit for bit. For a CUDA tensor and a Python float ``c``,
torch multiplies by a reciprocal computed on the host; this prints, for the
divisors the walk uses and two others, how many of 2^24 uniform values in
[0, 4) differ between ``x / c`` and (a) ``x * fp32(fp32(1) / fp32(c))``,
(b) ``x * fp32(1 / c)`` with 1 / c in double, (c) true division by
``fp32(c)``.

The encode kernel (``csrc/hashgrid_fwd.cu``) must reproduce the plain
encode's ``pos = x * scale + 0.5`` bit for bit, with ``scale`` an fp32
value passed as a Python float. For every level scale of the -O grid
(16 levels, bound 2) and of D-NeRF's, it prints how many of 2^24 uniform
values in [0, 1] differ between torch's ``x * scale + 0.5`` and the two
correctly rounded fp32 operations (computed exactly in float64, rounded
after each), and how many land in another cell (``floor``).

    python tools/probe_scalar_division.py

Needs one CUDA card.
"""

import math
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_scalar_division: CUDA is not available", file=sys.stderr)
        return 2
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(1 << 24, generator=g, device="cuda") * 4.0
    for c in (math.log(1 + 1 / 128), 2 * math.sqrt(3) / 1024, 3.0, 0.1):
        a = x / c
        single = x * float(np.float32(1.0) / np.float32(c))
        double = x * float(np.float32(1.0 / c))
        true = x / torch.tensor(float(np.float32(c)), device="cuda")
        print(f"c = {c!r}: x / c differs from x * fp32(1)/fp32(c) in {int((a != single).sum())}, "
              f"from x * fp32(1/c in double) in {int((a != double).sum())}, from x / fp32(c) in "
              f"{int((a != true).sum())} of {x.numel()}")
    from focnerf_tpu_torch.config import parse_options
    from focnerf_tpu_torch.ops.hashgrid import _level_scale

    u = torch.rand(1 << 24, generator=g, device="cuda")
    for name, spec in (("-O grid", parse_options(["scene", "-O"]).nerf_config().grid_spec),
                       ("D-NeRF field", parse_options(["scene", "-O"]).dnerf_config().field_spec)):
        differ = cells = 0
        for lvl in range(spec.num_levels):
            scale = _level_scale(spec, lvl)
            pos = u * scale + 0.5
            exact = ((u.double() * scale).float().double() + 0.5).float()
            differ += int((pos != exact).sum())
            cells += int((torch.floor(pos) != torch.floor(exact)).sum())
        print(f"{name}: x * scale + 0.5 differs from the two rounded fp32 ops in {differ}, in the cell in {cells}, "
              f"of {u.numel()} x {spec.num_levels} levels")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
