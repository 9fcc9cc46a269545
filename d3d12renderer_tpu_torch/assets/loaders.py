"""Mesh asset loaders: OBJ (with MTL) and PLY, the model types the FBX
importer fills, and mesh post-processing (counterpart of
``d3d12renderer_tpu/assets/loaders.py``; reference src/asset/obj.cpp,
src/asset/ply.cpp, src/asset/mesh_postprocessing.h:149).  Parsing stays on
the host in numpy; `LoadedSkeleton.to_skeleton` and `LoadedClip.to_clip`
build the port's animation types on a given device.
"""

from __future__ import annotations

import os
import struct as pystruct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..render.mesh import MeshData


@dataclass
class LoadedMaterial:
    name: str = ""
    albedo: Tuple[float, float, float] = (0.8, 0.8, 0.8)
    emissive: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    roughness: float = 0.5
    metallic: float = 0.0
    albedo_texture: Optional[str] = None


@dataclass
class SkinData:
    """Per-vertex skinning: up to 4 influences (reference:
    asset/model_asset.h skin weights, 4-influence LBS)."""

    joint_indices: np.ndarray   # (V, 4) int32 into the skeleton's joints
    joint_weights: np.ndarray   # (V, 4) float32, rows sum to 1


@dataclass
class LoadedSkeleton:
    """Host-side skeleton description (bind LOCAL transforms)."""

    names: List[str] = field(default_factory=list)
    parents: List[int] = field(default_factory=list)
    bind_local_pos: Optional[np.ndarray] = None   # (J, 3)
    bind_local_rot: Optional[np.ndarray] = None   # (J, 4)

    def to_skeleton(self, device="cuda"):
        from ..animation.animation import make_skeleton
        return make_skeleton(self.parents, self.bind_local_pos,
                             self.bind_local_rot, device=device)


@dataclass
class LoadedClip:
    """Uniform-grid resampled animation tracks (one entry per joint)."""

    name: str = ""
    positions: Optional[np.ndarray] = None   # (J, K, 3)
    rotations: Optional[np.ndarray] = None   # (J, K, 4)
    scales: Optional[np.ndarray] = None      # (J, K)
    duration: float = 0.0
    looping: bool = True

    def to_clip(self, device="cuda"):
        import torch

        from ..animation.animation import AnimationClip
        from ..cuda_build import resolve_device

        device = resolve_device(device)

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        return AnimationClip(
            positions=f32(self.positions), rotations=f32(self.rotations),
            scales=f32(self.scales), duration=float(self.duration),
            looping=self.looping,
        )


@dataclass
class ModelAsset:
    """Unified in-memory model (reference: asset/model_asset.h:51-58 —
    meshes, materials, skeletons, animations)."""

    meshes: List[MeshData] = field(default_factory=list)
    materials: List[LoadedMaterial] = field(default_factory=list)
    mesh_material: List[int] = field(default_factory=list)
    skeletons: List[LoadedSkeleton] = field(default_factory=list)
    animations: List[LoadedClip] = field(default_factory=list)
    # Per-mesh skin (None = rigid), indexing the first skeleton.
    mesh_skin: List[Optional[SkinData]] = field(default_factory=list)


# --------------------------------------------------------------------------
# OBJ / MTL (reference: asset/obj.cpp)
# --------------------------------------------------------------------------

def load_mtl(path: str) -> Dict[str, LoadedMaterial]:
    mats: Dict[str, LoadedMaterial] = {}
    cur: Optional[LoadedMaterial] = None
    if not os.path.exists(path):
        return mats
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if parts[0] == "newmtl":
                cur = LoadedMaterial(name=parts[1])
                mats[parts[1]] = cur
            elif cur is None:
                continue
            elif parts[0] == "Kd":
                cur.albedo = tuple(float(x) for x in parts[1:4])
            elif parts[0] == "Ke":
                cur.emissive = tuple(float(x) for x in parts[1:4])
            elif parts[0] == "Ns":  # shininess -> roughness
                cur.roughness = float(np.clip(1.0 - float(parts[1]) / 1000.0, 0.03, 1.0))
            elif parts[0] == "Pm":
                cur.metallic = float(parts[1])
            elif parts[0] == "Pr":
                cur.roughness = float(parts[1])
            elif parts[0] == "map_Kd":
                cur.albedo_texture = parts[-1]
    return mats


def load_obj(path: str) -> ModelAsset:
    positions: List = []
    normals: List = []
    uvs: List = []
    mats: Dict[str, LoadedMaterial] = {}
    mat_order: List[str] = []
    cur_mat = -1

    # Per-material triangle lists of (pos_i, uv_i, n_i) triples.
    faces: Dict[int, List] = {}

    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag == "v":
                positions.append([float(x) for x in parts[1:4]])
            elif tag == "vn":
                normals.append([float(x) for x in parts[1:4]])
            elif tag == "vt":
                uvs.append([float(parts[1]), float(parts[2])])
            elif tag == "mtllib":
                mtl_path = os.path.join(os.path.dirname(path), parts[1])
                mats.update(load_mtl(mtl_path))
            elif tag == "usemtl":
                name = parts[1]
                if name not in mat_order:
                    mat_order.append(name)
                cur_mat = mat_order.index(name)
            elif tag == "f":
                corners = []
                for vert in parts[1:]:
                    ids = vert.split("/")
                    pi = int(ids[0])
                    ti = int(ids[1]) if len(ids) > 1 and ids[1] else 0
                    ni = int(ids[2]) if len(ids) > 2 and ids[2] else 0
                    corners.append((pi, ti, ni))
                # Fan-triangulate polygons (reference obj.cpp does the same).
                for k in range(1, len(corners) - 1):
                    faces.setdefault(cur_mat, []).append(
                        (corners[0], corners[k], corners[k + 1]))

    positions = np.asarray(positions, np.float32)
    normals_arr = np.asarray(normals, np.float32) if normals else None
    uvs_arr = np.asarray(uvs, np.float32) if uvs else None

    def resolve(i, n):
        return (i - 1) if i > 0 else (n + i)

    asset = ModelAsset()
    material_list = [mats.get(nm, LoadedMaterial(name=nm)) for nm in mat_order]
    if not material_list:
        material_list = [LoadedMaterial(name="default")]
    asset.materials = material_list

    for mat_i, tris in faces.items():
        vp, vn, vt, idx = [], [], [], []
        cache: Dict[Tuple, int] = {}
        for tri in tris:
            tri_idx = []
            for (pi, ti, ni) in tri:
                key = (pi, ti, ni)
                if key not in cache:
                    cache[key] = len(vp)
                    vp.append(positions[resolve(pi, len(positions))])
                    vn.append(
                        normals_arr[resolve(ni, len(normals_arr))]
                        if (ni and normals_arr is not None) else [0, 0, 0])
                    vt.append(
                        uvs_arr[resolve(ti, len(uvs_arr))]
                        if (ti and uvs_arr is not None) else [0, 0])
                tri_idx.append(cache[key])
            idx.append(tri_idx)
        mesh = MeshData(
            np.asarray(vp, np.float32), np.asarray(vn, np.float32),
            np.asarray(vt, np.float32), np.asarray(idx, np.int32))
        if not normals or not np.linalg.norm(mesh.normals, axis=-1).all():
            mesh = generate_normals(mesh)
        asset.meshes.append(mesh)
        asset.mesh_material.append(max(mat_i, 0))
    return asset


# --------------------------------------------------------------------------
# PLY (reference: asset/ply.cpp) — ASCII and binary_little_endian
# --------------------------------------------------------------------------

_PLY_TYPES = {
    "float": ("f", 4), "float32": ("f", 4), "double": ("d", 8),
    "uchar": ("B", 1), "uint8": ("B", 1), "char": ("b", 1),
    "short": ("h", 2), "ushort": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4), "uint": ("I", 4), "uint32": ("I", 4),
}


def load_ply(path: str) -> ModelAsset:
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.find(b"end_header\n") + len(b"end_header\n")
    header = data[:head_end].decode("ascii", "replace").splitlines()
    body = data[head_end:]

    fmt = "ascii"
    elements = []  # (name, count, [(prop_type, prop_name) or ('list',...)])
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
            else:
                elements[-1][2].append((parts[1], parts[2]))

    verts = None
    vert_props: List[str] = []
    tris: List[List[int]] = []

    if fmt == "ascii":
        lines = body.decode("ascii", "replace").split("\n")
        li = 0
        for (name, count, props) in elements:
            if name == "vertex":
                vert_props = [p[1] for p in props]
                rows = []
                for _ in range(count):
                    rows.append([float(x) for x in lines[li].split()])
                    li += 1
                verts = np.asarray(rows, np.float32)
            elif name == "face":
                for _ in range(count):
                    vals = [int(x) for x in lines[li].split()]
                    li += 1
                    k = vals[0]
                    poly = vals[1:1 + k]
                    for j in range(1, k - 1):
                        tris.append([poly[0], poly[j], poly[j + 1]])
    else:  # binary_little_endian
        off = 0
        for (name, count, props) in elements:
            if name == "vertex":
                vert_props = [p[1] for p in props]
                fmt_str = "<" + "".join(_PLY_TYPES[p[0]][0] for p in props)
                size = pystruct.calcsize(fmt_str)
                rows = [
                    pystruct.unpack_from(fmt_str, body, off + i * size)
                    for i in range(count)
                ]
                off += count * size
                verts = np.asarray(rows, np.float32)
            elif name == "face":
                lp = props[0]
                cnt_fmt, cnt_sz = _PLY_TYPES[lp[1]]
                idx_fmt, idx_sz = _PLY_TYPES[lp[2]]
                for _ in range(count):
                    (k,) = pystruct.unpack_from("<" + cnt_fmt, body, off)
                    off += cnt_sz
                    poly = pystruct.unpack_from("<" + idx_fmt * k, body, off)
                    off += idx_sz * k
                    for j in range(1, k - 1):
                        tris.append([poly[0], poly[j], poly[j + 1]])

    pi = [vert_props.index(c) for c in ("x", "y", "z")]
    pos = verts[:, pi]
    if all(c in vert_props for c in ("nx", "ny", "nz")):
        ni = [vert_props.index(c) for c in ("nx", "ny", "nz")]
        nrm = verts[:, ni]
    else:
        nrm = np.zeros_like(pos)
    if all(c in vert_props for c in ("s", "t")):
        uv = verts[:, [vert_props.index("s"), vert_props.index("t")]]
    elif all(c in vert_props for c in ("u", "v")):
        uv = verts[:, [vert_props.index("u"), vert_props.index("v")]]
    else:
        uv = np.zeros((len(pos), 2), np.float32)

    mesh = MeshData(pos.astype(np.float32), nrm.astype(np.float32),
                    uv.astype(np.float32), np.asarray(tris, np.int32))
    if not np.linalg.norm(mesh.normals, axis=-1).all():
        mesh = generate_normals(mesh)
    asset = ModelAsset(meshes=[mesh], materials=[LoadedMaterial()],
                       mesh_material=[0])
    return asset


# --------------------------------------------------------------------------
# Mesh post-processing (reference: asset/mesh_postprocessing.h:149)
# --------------------------------------------------------------------------

def generate_normals(mesh: MeshData) -> MeshData:
    """Area-weighted vertex normals (native C++ path when available)."""
    from .native import compute_normals

    n = compute_normals(mesh.positions, mesh.indices)
    return MeshData(mesh.positions, n.astype(np.float32), mesh.uvs,
                    mesh.indices)


def generate_tangents(mesh: MeshData) -> np.ndarray:
    """(V, 3) tangents from UVs (reference: mesh_postprocessing tangents)."""
    p, uv, i = mesh.positions, mesh.uvs, mesh.indices
    t = np.zeros_like(p)
    e1 = p[i[:, 1]] - p[i[:, 0]]
    e2 = p[i[:, 2]] - p[i[:, 0]]
    du1 = uv[i[:, 1]] - uv[i[:, 0]]
    du2 = uv[i[:, 2]] - uv[i[:, 0]]
    r = du1[:, 0] * du2[:, 1] - du2[:, 0] * du1[:, 1]
    r = np.where(np.abs(r) < 1e-12, 1.0, r)
    tan = (e1 * du2[:, 1:2] - e2 * du1[:, 1:2]) / r[:, None]
    for k in range(3):
        np.add.at(t, i[:, k], tan)
    ln = np.linalg.norm(t, axis=-1, keepdims=True)
    fallback = np.tile([1.0, 0.0, 0.0], (len(p), 1))
    return np.where(ln > 1e-8, t / np.maximum(ln, 1e-12), fallback).astype(np.float32)


def weld_mesh(mesh: MeshData, tolerance=1e-5) -> MeshData:
    """Merge duplicate vertices (reference: mesh_postprocessing weld;
    native grid-hash path when available)."""
    from .native import weld_remap

    unique, remap = weld_remap(mesh.positions, tolerance)
    first = np.zeros(unique, np.int64)
    first[remap[::-1]] = np.arange(len(mesh.positions))[::-1]  # first hit wins
    return MeshData(
        mesh.positions[first], mesh.normals[first], mesh.uvs[first],
        remap[mesh.indices].astype(np.int32),
    )


def load_model(path: str) -> ModelAsset:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        return load_obj(path)
    if ext == ".ply":
        return load_ply(path)
    if ext == ".fbx":
        from .fbx import load_fbx

        return load_fbx(path)
    raise ValueError(f"unsupported model format: {ext}")
