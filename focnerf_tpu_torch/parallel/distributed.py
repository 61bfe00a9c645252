"""Process-group initialization: one process per device.

Twin of focnerf_tpu/parallel/distributed.py. JAX runs one process over a
mesh of devices and ``jax.distributed`` only joins hosts; torch runs one
process per device, launched by ``torchrun`` (or by the caller), and joins
them in ``torch.distributed``'s default process group:

  - ``initialize`` reads torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` and ``MASTER_PORT`` (arguments take precedence), picks
    the backend, binds the process to its card and prints one line;
  - the backend is NCCL when every rank of a host has a card of its own,
    else gloo: on the CPU, and for ranks that share one card (NCCL refuses
    two ranks on one GPU);
  - world size 1 goes through the same code, with an in-memory store;
  - ``timeout_s`` bounds the rendezvous and every collective after it: a
    rank whose peer never arrives raises instead of hanging (JAX's
    ``JAX_INIT_TIMEOUT`` contract).
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name, "")
    return int(value) if value else default


def choose_backend(device: torch.device, local_world_size: int) -> str:
    """NCCL when each rank of this host can have a card of its own, else gloo."""
    if device.type == "cuda" and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize(
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    *,
    local_rank: Optional[int] = None,
    init_method: Optional[str] = None,
    timeout_s: float = 300.0,
    device=None,
) -> dict:
    """Join (or create) the default process group; a second call returns the
    summary of the group that exists.

    ``init_method`` (e.g. ``file:///tmp/x`` or ``tcp://host:port``) overrides
    the ``MASTER_ADDR``/``MASTER_PORT`` rendezvous. ``device`` (None:
    ``cuda``) decides the backend; on CUDA the process is bound to card
    ``local_rank % device_count``. Returns {process_id, num_processes,
    local_devices, global_devices, backend}: every process drives one
    device, so local_devices is 1."""
    from focnerf_tpu_torch import resolve_device

    device = resolve_device(device)
    if not dist.is_initialized():
        rank = _env_int("RANK", 0) if rank is None else rank
        world_size = _env_int("WORLD_SIZE", 1) if world_size is None else world_size
        local_rank = _env_int("LOCAL_RANK", rank) if local_rank is None else local_rank
        local_world = _env_int("LOCAL_WORLD_SIZE", world_size)
        backend = choose_backend(device, local_world)
        if device.type == "cuda":
            torch.cuda.set_device(local_rank % torch.cuda.device_count())
        kw = dict(backend=backend, rank=rank, world_size=world_size, timeout=timedelta(seconds=timeout_s))
        if init_method is None and "MASTER_ADDR" in os.environ:
            init_method = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
        if init_method is not None:
            kw["init_method"] = init_method
        elif world_size == 1:
            kw["store"] = dist.HashStore()
        else:
            raise ValueError(f"world size {world_size} needs an init_method or MASTER_ADDR/MASTER_PORT")
        dist.init_process_group(**kw)
        print(f"[distributed] rank {rank}/{world_size} backend {backend} device {device.type}"
              + (f":{torch.cuda.current_device()}" if device.type == "cuda" else ""), flush=True)
    return {
        "process_id": dist.get_rank(),
        "num_processes": dist.get_world_size(),
        "local_devices": 1,
        "global_devices": dist.get_world_size(),
        "backend": dist.get_backend(),
    }


def is_main_process() -> bool:
    """Rank 0 of the default group (True before any group exists)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def shutdown() -> None:
    """Leave the default process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()
