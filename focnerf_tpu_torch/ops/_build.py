"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``focnerf_tpu_torch/build/`` (listed in
``.gitignore``). The library's file name carries a hash of its source, so a
changed source builds anew and an unchanged one is loaded as it is. Nothing
is built when a module is imported: a wrapper builds its library at its
first launch, and ``build_all`` builds every library at once, one ``nvcc``
process per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "build")
KERNEL_SOURCES = ("composite", "hashgrid_bwd", "hashgrid_fwd", "march_skip")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """nvcc from PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def library_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def build_all(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, str]:
    """Compile every ``csrc/<name>.cu`` whose library is missing, one nvcc
    process each, all running at once; returns {name: library path}."""
    outs = {name: library_path(name) for name in names}
    todo = {name: out for name, out in outs.items() if not os.path.exists(out)}
    if todo:
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = find_nvcc()
        procs = {}
        for name, out in todo.items():
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}) for {todo[name]}:\n{log}")
            else:
                os.replace(tmp, todo[name])  # atomic: a concurrent loader never sees a partial file
        if failed:
            raise RuntimeError("\n".join(failed))
    return outs


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if missing."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(build_all((name,))[name])
    return lib
