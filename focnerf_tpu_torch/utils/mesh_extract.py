"""Iso-surface extraction from a dense density grid, and mesh export.

Twin of focnerf_tpu/utils/mesh_extract.py (host code, not a device kernel):

  - marching tetrahedra (six tetrahedra per cube around its main diagonal):
    the C++ implementation in ``native/marching_tets.cpp``, compiled with
    ``g++`` into ``focnerf_tpu_torch/build/`` at first use and called
    through ctypes, or, when it cannot be built, a vectorized numpy version
    of the same decomposition; ``marching_tets`` prints which ran;
  - ``weld_vertices`` turns the triangle soup into an indexed mesh;
  - ``extract_fields`` queries a density function on a dense grid over the
    bound box (on its device, without gradients), and ``extract_mesh``
    meshes that grid: the hash field's mesh export;
  - ``mesh_from_volume`` meshes a baked volume's sigma channel directly;
  - OBJ / PLY writers.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NATIVE_SOURCE = os.path.join(_ROOT, "native", "marching_tets.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_native = {}  # stem -> (the loaded library or None, its path or why it is None)


def build_native(source: str, stem: str, flags=CXX_FLAGS):
    """The C++ file ``source`` compiled with ``flags`` into BUILD_DIR, under
    ``lib<stem>_<hash>.so`` keyed by the source's and the flags' hash (an
    existing file is reused), and loaded; built at the first call for
    ``stem`` and kept. Returns (library, its path) or (None, why not).
    Nothing is written beside the source."""
    if stem not in _native:
        try:
            _native[stem] = _compile(source, stem, flags)
        except (OSError, subprocess.SubprocessError) as e:
            _native[stem] = (None, f"{type(e).__name__}: {e}")
    return _native[stem]


def _compile(source: str, stem: str, flags):
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None or not os.path.exists(source):
        return None, f"no C++ compiler or no {os.path.relpath(source, _ROOT)}"
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run([cxx, *flags, "-o", tmp, source], capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            return None, f"g++ failed ({proc.returncode}): {proc.stderr.strip()[:200]}"
        os.replace(tmp, out)
    return ctypes.CDLL(out), out


def native_lib():
    """The marching-tetrahedra library, built at the first call; None when
    it cannot be built (``build_native``'s note says why)."""
    lib, _ = build_native(NATIVE_SOURCE, "marching_tets")
    if lib is not None:
        lib.marching_tets.restype = ctypes.c_int64
        lib.marching_tets.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ]
    return lib


_TETS = np.array([[0, 5, 1, 3], [0, 5, 3, 7], [0, 5, 7, 4], [0, 7, 3, 2], [0, 7, 2, 6], [0, 7, 6, 4]])


def _marching_tets_numpy(grid: np.ndarray, iso: float) -> np.ndarray:
    """Vectorized numpy marching tetrahedra (the C++ decomposition)."""
    nx, ny, nz = grid.shape
    vals = np.empty((nx - 1, ny - 1, nz - 1, 8), np.float32)
    pos = np.empty((nx - 1, ny - 1, nz - 1, 8, 3), np.float32)
    base = np.stack(np.meshgrid(np.arange(nx - 1), np.arange(ny - 1), np.arange(nz - 1), indexing="ij"),
                    -1).astype(np.float32)
    for c in range(8):
        dx, dy, dz = c & 1, (c >> 1) & 1, (c >> 2) & 1
        vals[..., c] = grid[dx : nx - 1 + dx, dy : ny - 1 + dy, dz : nz - 1 + dz]
        pos[..., c, :] = base + np.array([dx, dy, dz], np.float32)

    inside = vals > iso
    mixed = inside.any(-1) & (~inside).any(-1)  # boundary cubes only
    vals = vals[mixed]  # [M, 8]
    pos = pos[mixed]  # [M, 8, 3]

    def edge(pi, pj, vi, vj):
        denom = vj - vi
        t = np.where(denom == 0, 0.5, (iso - vi) / np.where(denom == 0, 1, denom))
        t = np.clip(t, 0, 1)[..., None]
        return pi + t * (pj - pi)

    tris = []
    for tet in _TETS:
        tv = vals[:, tet]  # [M, 4]
        tp = pos[:, tet]  # [M, 4, 3]
        m = (tv > iso).astype(np.int8)
        code = m[:, 0] + 2 * m[:, 1] + 4 * m[:, 2] + 8 * m[:, 3]
        for case in range(1, 15):
            sel = code == case
            if not sel.any():
                continue
            ins = [v for v in range(4) if case & (1 << v)]
            outs = [v for v in range(4) if not case & (1 << v)]
            Vv, P = tv[sel], tp[sel]
            if len(ins) == 1:
                i = ins[0]
                tris.append(np.stack([edge(P[:, i], P[:, o], Vv[:, i], Vv[:, o]) for o in outs], 1))
            elif len(ins) == 3:
                o = outs[0]
                tris.append(np.stack([edge(P[:, i], P[:, o], Vv[:, i], Vv[:, o]) for i in ins], 1))
            else:  # 2 in / 2 out: a quad, two triangles
                i0, i1 = ins
                o0, o1 = outs
                a = edge(P[:, i0], P[:, o0], Vv[:, i0], Vv[:, o0])
                b = edge(P[:, i0], P[:, o1], Vv[:, i0], Vv[:, o1])
                c = edge(P[:, i1], P[:, o1], Vv[:, i1], Vv[:, o1])
                d = edge(P[:, i1], P[:, o0], Vv[:, i1], Vv[:, o0])
                tris.append(np.stack([a, b, c], 1))
                tris.append(np.stack([a, c, d], 1))
    if not tris:
        return np.zeros((0, 3, 3), np.float32)
    return np.concatenate(tris, 0)


def marching_tets(grid: np.ndarray, iso: float) -> np.ndarray:
    """Triangle soup [T, 3, 3] in grid-index coordinates."""
    lib = native_lib()
    if lib is None:
        print(f"[mesh] marching tetrahedra: numpy ({build_native(NATIVE_SOURCE, 'marching_tets')[1]})")
        return _marching_tets_numpy(grid, iso)
    print(f"[mesh] marching tetrahedra: native ({os.path.basename(build_native(NATIVE_SOURCE, 'marching_tets')[1])})")
    g = np.ascontiguousarray(grid, np.float32)
    ptr = g.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    n = lib.marching_tets(ptr, *g.shape, iso, None, 0)
    out = np.empty((int(n), 9), np.float32)
    lib.marching_tets(ptr, *g.shape, iso, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), int(n))
    return out.reshape(-1, 3, 3)


def weld_vertices(tri_soup: np.ndarray, decimals: int = 5):
    """Triangle soup -> (verts [V, 3], faces [F, 3]) by exact-coordinate
    weld; degenerate faces dropped."""
    key = np.round(tri_soup.reshape(-1, 3), decimals)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    faces = inv.reshape(-1, 3)
    good = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    return uniq.astype(np.float32), faces[good].astype(np.int32)


def extract_fields(density_eval, bound: float, resolution: int = 256, device="cpu",
                   slabs: int = 8) -> np.ndarray:
    """sigma [R, R, R] at the points (xs[i], xs[j], xs[k]), xs =
    linspace(-bound, bound, R), from ``density_eval`` (points [..., 3] on
    ``device`` -> sigma [...]), ``slabs`` x-slabs a call (utils.py:512-527)."""
    xs = torch.from_numpy(np.linspace(-bound, bound, resolution, dtype=np.float32)).to(device)
    yy, zz = torch.meshgrid(xs, xs, indexing="ij")
    grid = np.empty((resolution, resolution, resolution), np.float32)
    with torch.no_grad():
        for x0 in range(0, resolution, slabs):
            xx = xs[x0 : x0 + slabs]
            pts = torch.stack([xx[:, None, None].expand(-1, resolution, resolution),
                               yy.expand(len(xx), -1, -1), zz.expand(len(xx), -1, -1)], -1)
            grid[x0 : x0 + len(xx)] = density_eval(pts).float().cpu().numpy()
    return grid


def extract_mesh(density_eval, bound: float, resolution: int = 256, threshold: float = 10.0, device="cpu"):
    """Density grid -> marching tetrahedra -> (verts in world coordinates
    [-bound, bound]^3, faces)."""
    grid = extract_fields(density_eval, bound, resolution, device)
    verts, faces = weld_vertices(marching_tets(grid, threshold))
    verts = verts / (resolution - 1) * (2 * bound) - bound
    return verts, faces


def mesh_from_volume(vol, threshold: float = 10.0):
    """Mesh a BakedVolume's sigma channel (its last) at ``threshold``:
    (verts in world coordinates [-bound, bound]^3, faces)."""
    grid = vol.rgba[..., -1].detach().float().cpu().numpy()
    verts, faces = weld_vertices(marching_tets(grid, threshold))
    resolution = grid.shape[0]
    verts = verts / (resolution - 1) * (2 * vol.bound) - vol.bound
    return verts, faces


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray):
    with open(path, "w") as f:
        f.writelines(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n" for v in verts)
        f.writelines(f"f {t[0]} {t[1]} {t[2]}\n" for t in faces + 1)  # OBJ is 1-indexed


def save_ply(path: str, verts: np.ndarray, faces: np.ndarray):
    with open(path, "wb") as f:
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(verts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n"
        )
        f.write(header.encode())
        f.write(verts.astype("<f4").tobytes())
        body = np.empty(len(faces), dtype=[("n", "u1"), ("idx", "<i4", 3)])
        body["n"] = 3
        body["idx"] = faces
        f.write(body.tobytes())
