"""FLOP and random-access traffic counter for eager programs (roofline / MFU).

Twin of focnerf_tpu/utils/flops.py. JAX walks a jaxpr and multiplies loop
bodies by their trip counts; eager torch runs the program instead, so
``count_program`` runs ``fn`` once under a ``TorchDispatchMode`` and every
op is counted as often as it runs: a Python loop of N matmuls counts N
times, and a backward run inside ``fn`` counts too (autograd's threads
inherit the mode). It counts the LOGICAL work of one execution:

- ``flops``: matmul work, 2 * M * N * K per contraction (mm, addmm, bmm,
  baddbmm, convolutions; ``torch.utils.flop_counter.FlopCounterMode``'s
  formulas). Elementwise flops are excluded, as in JAX's count: MFU is
  model flops over the matmul peak.
- ``gather_bytes``: the bytes random-access ops move: gathers (``index``,
  i.e. advanced indexing, ``index_select``, ``gather``, ``embedding``,
  ``take``) read and write their output (2x its bytes), scatters
  (``index_add``, ``index_put``, ``scatter``, ``scatter_add``,
  ``scatter_reduce``, ``index_copy``) read, modify and write their updates
  (3x). The ported table-gradient kernel is opaque to the dispatcher, so
  its wrapper reports its scatter, 3x the (point, column) contributions it
  adds, through ``note_kernel_bytes``, and the encode kernels their table
  gathers (2x the gathered rows' bytes, as a gather counts); the composite
  kernels stream their rows and address nothing at random.

``dynamic_while`` is always False: an eager run executes every loop.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# The public peaks of one NVIDIA H100 SXM5 (NVIDIA H100 Tensor Core GPU
# datasheet: dense BF16 tensor-core rate without sparsity, HBM3 bandwidth),
# by the name torch.cuda.get_device_name gives the card.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
}

_GATHERS = {"index", "index_select", "gather", "embedding", "take"}
# scatter -> the position of its update operand
_SCATTERS = {"index_add": 3, "index_put": 2, "_index_put_impl": 2, "scatter": 3, "scatter_add": 3,
             "scatter_reduce": 3, "index_copy": 3}

_ACTIVE: List["_GatherCounter"] = []


def _nbytes(t) -> float:
    return float(t.numel() * t.element_size()) if torch.is_tensor(t) else 0.0


def note_kernel_bytes(nbytes: float) -> None:
    """A hand-written kernel's random-access bytes, for the active counts."""
    for counter in _ACTIVE:
        counter.gather_bytes += nbytes


class _GatherCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.gather_bytes = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__.rstrip("_")
        if name in _GATHERS:
            self.gather_bytes += 2.0 * _nbytes(out)
        elif name in _SCATTERS:
            upd = args[_SCATTERS[name]]
            if not torch.is_tensor(upd) or upd.numel() == 1:  # a broadcast value: each addressed element
                if name in ("index_put", "_index_put_impl"):
                    count = args[1][0].numel() * math.prod(args[0].shape[len(args[1]):])
                else:
                    count = args[2].numel()
                self.gather_bytes += 3.0 * count * args[0].element_size()
            else:
                self.gather_bytes += 3.0 * _nbytes(upd)
        return out


def count_program(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and count its matmul flops and
    random-access bytes -> {"flops", "gather_bytes", "dynamic_while"}."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = _GatherCounter()
    with FlopCounterMode(display=False) as flops:
        _ACTIVE.append(counter)
        try:
            with counter:
                fn(*args, **kwargs)
        finally:
            _ACTIVE.remove(counter)
    return {"flops": float(flops.get_total_flops()), "gather_bytes": counter.gather_bytes,
            "dynamic_while": False}


def roofline(
    fn,
    *args,
    step_seconds: float,
    steps_per_program: int = 1,
    device_name: Optional[str] = None,
    peak_flops: Optional[float] = None,
    hbm_bytes_per_s: Optional[float] = None,
    **kwargs,
) -> dict:
    """MFU and random-access bandwidth share of one measured program.

    ``step_seconds`` is the measured time of ONE step; ``steps_per_program``
    divides the counted work when ``fn`` runs K steps. The peaks are the
    arguments', else ``PEAKS[device_name]`` (default: card 0's name when
    there is a card). A device without a known peak gets None for ``mfu``
    and ``hbm_gather_util``: there is no default peak.
    """
    if device_name is None and torch.cuda.is_available():
        device_name = torch.cuda.get_device_name(0)
    known = PEAKS.get(device_name, {})
    peak_flops = peak_flops if peak_flops is not None else known.get("bf16_flops")
    hbm_bytes_per_s = hbm_bytes_per_s if hbm_bytes_per_s is not None else known.get("hbm_bytes_per_s")
    c = count_program(fn, *args, **kwargs)
    flops_per_step = c["flops"] / steps_per_program
    gbytes_per_step = c["gather_bytes"] / steps_per_program
    return {
        "flops_per_step": flops_per_step,
        "gather_bytes_per_step": gbytes_per_step,
        "achieved_tflops": flops_per_step / step_seconds / 1e12,
        "mfu": None if peak_flops is None else flops_per_step / step_seconds / peak_flops,
        "gather_gbps": gbytes_per_step / step_seconds / 1e9,
        "hbm_gather_util": None if hbm_bytes_per_s is None else gbytes_per_step / step_seconds / hbm_bytes_per_s,
        "lower_bound": False,
        "device": device_name,
    }
