"""Host-side threaded batch sampler backed by ``native/dataloader.cpp``.

Twin of focnerf_tpu/data/native_loader.py: the host pipeline of
``--no-preload`` (the role torch's DataLoader plays in the reference,
nerf/provider.py:398-459). The images stay on the host as one uint8
[V, H*W, C] buffer; C++ worker threads sample (view, pixel indices,
normalized pixels) batches into a bounded ring, so the next batch is drawn
while the device steps.

The library is compiled from ``native/dataloader.cpp`` with ``g++`` at the
first use, into ``focnerf_tpu_torch/build/`` under a file name keyed by the
hash of the source and the flags (``utils/mesh_extract.build_native``, which
also builds the mesh export's marching tetrahedra). Nothing is written into
``native/``.
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import numpy as np

from focnerf_tpu_torch.utils.mesh_extract import _ROOT, CXX_FLAGS, build_native

SOURCE = os.path.join(_ROOT, "native", "dataloader.cpp")
FLAGS = CXX_FLAGS + ("-pthread",)


def _lib():
    """The loader library, built at the first call (``build_native``), with
    its prototypes registered; None when it cannot be built
    (``library_note()`` says why)."""
    lib, _ = build_native(SOURCE, "dataloader", FLAGS)
    if lib is not None:
        lib.loader_create.restype = ctypes.c_void_p
        lib.loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),  # images [V, P, C]
            ctypes.c_int64,  # views
            ctypes.c_int64,  # pixels
            ctypes.c_int64,  # channels
            ctypes.c_int,  # batch_rays
            ctypes.c_int,  # n_threads
            ctypes.c_int,  # queue_capacity
            ctypes.c_uint64,  # seed
        ]
        lib.loader_next.restype = None
        lib.loader_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.loader_destroy.restype = None
        lib.loader_destroy.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    return _lib() is not None


def library_note() -> str:
    """The built library's path, or why it could not be built."""
    return build_native(SOURCE, "dataloader", FLAGS)[1]


class NativeBatchLoader:
    """Threaded (view, ray indices, pixels) sampler over a uint8 image stack.

    ``images`` must be uint8 [V, P, C]; the loader keeps a C-contiguous
    reference for its lifetime (the C side holds a borrowed pointer). With
    one worker thread the sequence of batches is a function of ``seed``.
    """

    def __init__(self, images: np.ndarray, batch_rays: int, *, n_threads: int = 2, queue_capacity: int = 4,
                 seed: int = 0):
        lib = _lib()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {library_note()}")
        if images.dtype != np.uint8 or images.ndim != 3:
            raise ValueError(f"NativeBatchLoader needs uint8 [V, P, C] images, got {images.dtype} {images.shape}")
        self._images = np.ascontiguousarray(images)  # keep the buffer alive
        self._lib = lib
        v, p, c = self._images.shape
        self.views, self.pixels, self.channels = v, p, c
        self.batch_rays = int(batch_rays)
        self._handle = lib.loader_create(
            self._images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            v, p, c, self.batch_rays, n_threads, queue_capacity,
            ctypes.c_uint64(np.uint64(seed if seed else 0x9E3779B97F4A7C15)),
        )
        # reusable output buffers (loader_next copies into caller memory)
        self._view = np.zeros((1,), np.int32)
        self._inds = np.zeros((self.batch_rays,), np.int32)
        self._pix = np.zeros((self.batch_rays, c), np.float32)

    def next(self) -> Tuple[int, np.ndarray, np.ndarray]:
        """Blocking: (view, ray indices [n] int32, float32 pixels [n, C] in
        [0, 1]). The arrays are copies (safe to hold across calls)."""
        if not self._handle:
            raise RuntimeError("NativeBatchLoader is closed")
        self._lib.loader_next(
            self._handle,
            self._view.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self._inds.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self._pix.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return int(self._view[0]), self._inds.copy(), self._pix.copy()

    def close(self):
        """Stop and join the worker threads and free the ring (idempotent)."""
        if getattr(self, "_handle", None):
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover - gc timing
        self.close()
