"""How torch's CUDA kernels divide a tensor by a Python float, on the card.

The skip-walk kernel (``csrc/march_skip.cu``) must reproduce the plain
walk's ``x / c`` bit for bit. For a CUDA tensor and a Python float ``c``,
torch multiplies by a reciprocal computed on the host; this prints, for the
divisors the walk uses and two others, how many of 2^24 uniform values in
[0, 4) differ between ``x / c`` and (a) ``x * fp32(fp32(1) / fp32(c))``,
(b) ``x * fp32(1 / c)`` with 1 / c in double, (c) true division by
``fp32(c)``.

    python tools/probe_scalar_division.py

Needs one CUDA card.
"""

import math
import sys

import numpy as np
import torch


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
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
