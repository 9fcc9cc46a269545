"""The mesh import helpers on the host (counterpart of
``d3d12renderer_tpu/assets/native.py``): vertex welding, area-weighted
normals and a fast OBJ geometry scan, through the port's own C++ copies in
`csrc/mesh_ops.cpp`, built with g++ at first use into the host library
(`cuda_build.load_host_library`, beside the BVH builder, which covers the
JAX module's `bvh_build_arrays`).  As in the JAX module, each function has
a numpy route, taken when the library cannot be built
(`native_available()` is then False).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from ..cuda_build import load_host_library

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if not _tried:
        _tried = True
        try:
            _lib = load_host_library()
        except (OSError, RuntimeError):
            _lib = None
    return _lib


def native_available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray):
    return ctypes.c_void_p(a.ctypes.data)


def weld_remap(positions: np.ndarray, tolerance: float = 1e-5
               ) -> Tuple[int, np.ndarray]:
    """(unique_count, remap): vertices closer than `tolerance` (by grid
    cell) merge; remap[i] is the new index of vertex i."""
    positions = np.ascontiguousarray(positions, np.float32)
    n = len(positions)
    lib = _load()
    if lib is not None:
        remap = np.empty(n, np.int32)
        unique = lib.weld_vertices(_ptr(positions), n,
                                   ctypes.c_float(tolerance), _ptr(remap))
        return int(unique), remap
    key = np.round(positions / tolerance).astype(np.int64)
    _, first, inverse = np.unique(key, axis=0, return_index=True,
                                  return_inverse=True)
    return len(first), inverse.astype(np.int32)


def compute_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """(V, 3) area-weighted unit vertex normals."""
    positions = np.ascontiguousarray(positions, np.float32)
    indices = np.ascontiguousarray(indices, np.int32)
    lib = _load()
    if lib is not None:
        out = np.empty_like(positions)
        lib.generate_normals(_ptr(positions), len(positions), _ptr(indices),
                             len(indices), _ptr(out))
        return out
    fn = np.cross(positions[indices[:, 1]] - positions[indices[:, 0]],
                  positions[indices[:, 2]] - positions[indices[:, 0]])
    out = np.zeros_like(positions)
    for k in range(3):
        np.add.at(out, indices[:, k], fn)
    ln = np.linalg.norm(out, axis=-1, keepdims=True)
    return (out / np.maximum(ln, 1e-12)).astype(np.float32)


def parse_obj_geometry(text: str) -> Tuple[np.ndarray, np.ndarray]:
    """Positions (V, 3) and fan-triangulated faces (T, 3) of OBJ text (the
    full material-aware loader is `loaders.load_obj`)."""
    lib = _load()
    data = text.encode()
    if lib is not None:
        nv = ctypes.c_int64()
        nt = ctypes.c_int64()
        lib.obj_count(data, len(data), ctypes.byref(nv), ctypes.byref(nt))
        pos = np.empty((nv.value, 3), np.float32)
        idx = np.empty((nt.value, 3), np.int32)
        lib.obj_parse(data, len(data), _ptr(pos), _ptr(idx))
        return pos, idx
    positions, tris = [], []
    for line in text.splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "v":
            positions.append([float(x) for x in parts[1:4]])
        elif parts[0] == "f":
            ids = [int(v.split("/")[0]) - 1 for v in parts[1:]]
            for k in range(1, len(ids) - 1):
                tris.append([ids[0], ids[k], ids[k + 1]])
    return (np.asarray(positions, np.float32), np.asarray(tris, np.int32))
