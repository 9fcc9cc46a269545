"""FBX import and export on the host (counterpart of
``d3d12renderer_tpu/assets/fbx.py``; reference src/asset/fbx.cpp and its
zlib-packed property arrays, src/asset/deflate.cpp).

The binary node-record reader (versions 7100-7700, typed and compressed
arrays) and the ASCII reader build one node tree; the object graph gives
the geometry (fan-triangulated polygons, normals and UVs in the usual
mapping modes), the skeleton (LimbNode models and their bind transforms),
the skin (clusters over control points, expanded to polygon vertices) and
the animation, resampled to a uniform key grid.  `write_fbx_skinned` and
`write_fbx_geometry` write minimal binary files that both packages read.
Numpy throughout, as the JAX package's module is; it must give the same
arrays, triangle order included (the raster tie rule sees triangle ids).
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .loaders import LoadedMaterial, ModelAsset, generate_normals
from ..render.mesh import MeshData

MAGIC = b"Kaydara FBX Binary  \x00\x1a\x00"


@dataclass
class FBXNode:
    name: str
    properties: List[Any] = field(default_factory=list)
    children: List["FBXNode"] = field(default_factory=list)

    def find(self, name: str) -> Optional["FBXNode"]:
        for c in self.children:
            if c.name == name:
                return c
        return None

    def find_all(self, name: str) -> List["FBXNode"]:
        return [c for c in self.children if c.name == name]


_SCALAR = {
    b"Y": ("<h", 2), b"C": ("<b", 1), b"I": ("<i", 4),
    b"F": ("<f", 4), b"D": ("<d", 8), b"L": ("<q", 8),
}
_ARRAY = {
    b"f": np.float32, b"d": np.float64, b"l": np.int64, b"i": np.int32,
    b"b": np.uint8,
}


def _read_property(buf: bytes, off: int) -> Tuple[Any, int]:
    code = buf[off:off + 1]
    off += 1
    if code in _SCALAR:
        fmt, size = _SCALAR[code]
        return struct.unpack_from(fmt, buf, off)[0], off + size
    if code in _ARRAY:
        n, enc, comp_len = struct.unpack_from("<III", buf, off)
        off += 12
        dtype = _ARRAY[code]
        raw = buf[off:off + comp_len]
        off += comp_len
        if enc == 1:
            raw = zlib.decompress(raw)
        return np.frombuffer(raw, dtype=dtype, count=n), off
    if code == b"S" or code == b"R":
        n = struct.unpack_from("<I", buf, off)[0]
        off += 4
        data = buf[off:off + n]
        off += n
        return (data.decode("utf-8", "replace") if code == b"S" else data), off
    raise ValueError(f"unknown FBX property type {code!r} at {off}")


def _read_node(buf: bytes, off: int, big: bool) -> Tuple[Optional[FBXNode], int]:
    if big:
        end, num_props, _plen = struct.unpack_from("<QQQ", buf, off)
        off += 24
    else:
        end, num_props, _plen = struct.unpack_from("<III", buf, off)
        off += 12
    name_len = buf[off]
    off += 1
    if end == 0 and num_props == 0 and name_len == 0:
        return None, off  # null record (list terminator)
    name = buf[off:off + name_len].decode("utf-8", "replace")
    off += name_len
    node = FBXNode(name)
    for _ in range(num_props):
        prop, off = _read_property(buf, off)
        node.properties.append(prop)
    while off < end:
        child, off = _read_node(buf, off, big)
        if child is None:
            break
        node.children.append(child)
    return node, max(off, end)


def parse_fbx(data: bytes) -> Tuple[FBXNode, int]:
    """Full binary node tree + version."""
    if not data.startswith(MAGIC):
        raise ValueError("not a binary FBX file")
    version = struct.unpack_from("<I", data, len(MAGIC))[0]
    big = version >= 7500
    off = len(MAGIC) + 4
    root = FBXNode("")
    while off < len(data):
        node, off = _read_node(data, off, big)
        if node is None:
            break
        root.children.append(node)
    return root, version


def _triangulate(poly_idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """FBX PolygonVertexIndex -> (T,3) position indices + source polygon-vertex
    slots (for per-polygon-vertex attributes).  Negative entry = XOR'd last
    index of a polygon (reference: fbx.cpp polygon decode)."""
    tris = []
    slots = []
    poly: List[int] = []
    pslots: List[int] = []
    for slot, v in enumerate(poly_idx):
        idx = int(v)
        last = idx < 0
        if last:
            idx = ~idx
        poly.append(idx)
        pslots.append(slot)
        if last:
            for k in range(1, len(poly) - 1):
                tris.append([poly[0], poly[k], poly[k + 1]])
                slots.append([pslots[0], pslots[k], pslots[k + 1]])
            poly, pslots = [], []
    return np.asarray(tris, np.int64), np.asarray(slots, np.int64)


def _layer_values(geom: FBXNode, layer_name: str, value_name: str,
                  index_name: str, width: int):
    """(values (K, width), mapping, per-slot index or None)."""
    layer = geom.find(layer_name)
    if layer is None:
        return None, None, None
    vals = None
    idx = None
    mapping = "ByPolygonVertex"
    for c in layer.children:
        if c.name == value_name:
            vals = np.asarray(c.properties[0], np.float64).reshape(-1, width)
        elif c.name == index_name:
            idx = np.asarray(c.properties[0], np.int64)
        elif c.name == "MappingInformationType":
            mapping = c.properties[0]
    return vals, mapping, idx


# --------------------------------------------------------------------------
# ASCII FBX (reference: fbx.cpp ASCII variant)
# --------------------------------------------------------------------------

def parse_fbx_ascii(text: str) -> FBXNode:
    """Text-format FBX -> the same FBXNode tree as the binary parser."""
    i = 0
    n = len(text)

    def skip_ws():
        nonlocal i
        while i < n:
            c = text[i]
            if c == ";":                       # comment to end of line
                while i < n and text[i] != "\n":
                    i += 1
            elif c in " \t\r\n,":
                i += 1
            else:
                break

    def read_value():
        nonlocal i
        skip_ws()
        c = text[i]
        if c == '"':
            i += 1
            start = i
            while text[i] != '"':
                i += 1
            s = text[start:i]
            i += 1
            return s
        if c == "*":                           # array: *N { a: csv }
            i += 1
            start = i
            while text[i].isdigit():
                i += 1
            count = int(text[start:i])
            skip_ws()
            assert text[i] == "{", "array without block"
            i += 1
            skip_ws()
            assert text[i] == "a" and text[i + 1] == ":", "array without a:"
            i += 2
            start = i
            while text[i] != "}":
                i += 1
            vals = [v for v in text[start:i].replace("\n", ",").split(",")
                    if v.strip()]
            i += 1
            arr = np.asarray([float(v) for v in vals])
            if np.all(arr == np.round(arr)) and np.abs(arr).max(initial=0) < 2**62:
                # Integer-valued arrays keep integer dtype (indices, times).
                return arr.astype(np.int64)[:count]
            return arr[:count]
        # bare token: number or identifier (Y/N etc.)
        start = i
        while i < n and text[i] not in ",{}\n\r\t ;":
            i += 1
        tok = text[start:i]
        try:
            return int(tok)
        except ValueError:
            try:
                return float(tok)
            except ValueError:
                return tok

    def parse_block(parent: FBXNode, end_char: str):
        nonlocal i
        while True:
            skip_ws()
            if i >= n:
                return
            if text[i] == end_char:
                i += 1
                return
            # Node name up to ':'
            start = i
            while text[i] not in ":":
                i += 1
            name = text[start:i].strip()
            i += 1  # ':'
            node = FBXNode(name)
            parent.children.append(node)
            # Properties until newline or '{'
            while True:
                # Peek: skip spaces/commas but NOT newlines.
                while i < n and text[i] in " \t\r,":
                    i += 1
                if i >= n or text[i] in "\n;":
                    break
                if text[i] == "{":
                    i += 1
                    parse_block(node, "}")
                    break
                node.properties.append(read_value())

    root = FBXNode("")
    parse_block(root, "\0")
    return root


# --------------------------------------------------------------------------
# Object graph + import
# --------------------------------------------------------------------------

KTIME_PER_SEC = 46186158000  # FBX KTime ticks per second


def _props70(node: FBXNode) -> Dict[str, List[Any]]:
    """Properties70 { P: "name", "type", "", "flags", v... } -> name -> values."""
    out: Dict[str, List[Any]] = {}
    p70 = node.find("Properties70")
    if p70 is None:
        return out
    for p in p70.children:
        if p.name == "P" and p.properties:
            out[p.properties[0]] = p.properties[4:]
    return out


def _euler_deg_to_quat(e):
    """FBX EulerXYZ (degrees) -> quaternion q = qz * qy * qx
    (reference: fbx.cpp rotation composition)."""
    rx, ry, rz = np.deg2rad(np.asarray(e, np.float64))

    def axis_q(axis, a):
        v = np.zeros(3)
        v[axis] = np.sin(a / 2)
        return np.array([*v, np.cos(a / 2)])

    def qmul(a, b):
        ax, ay, az, aw = a
        bx, by, bz, bw = b
        return np.array([
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ])

    return qmul(axis_q(2, rz), qmul(axis_q(1, ry), axis_q(0, rx)))


class _Doc:
    """Indexed view of the parsed tree: objects by id + connection maps."""

    def __init__(self, root: FBXNode):
        objects = root.find("Objects")
        if objects is None:
            raise ValueError("FBX has no Objects node")
        self.objects = objects
        self.by_id: Dict[int, FBXNode] = {}
        for node in objects.children:
            if node.properties and isinstance(node.properties[0],
                                              (int, np.integer)):
                self.by_id[int(node.properties[0])] = node

        # Connections: child object -> [(parent_id, prop-or-None)]
        self.parents_of: Dict[int, List[Tuple[int, Optional[str]]]] = {}
        self.children_of: Dict[int, List[Tuple[int, Optional[str]]]] = {}
        conns = root.find("Connections")
        for c in (conns.children if conns else []):
            if c.name != "C" or len(c.properties) < 3:
                continue
            kind = c.properties[0]
            src, dst = int(c.properties[1]), int(c.properties[2])
            prop = c.properties[3] if kind == "OP" and len(c.properties) > 3 \
                else None
            self.parents_of.setdefault(src, []).append((dst, prop))
            self.children_of.setdefault(dst, []).append((src, prop))

    def children(self, obj_id: int, name: str, subtype: Optional[str] = None):
        out = []
        for src, prop in self.children_of.get(obj_id, []):
            node = self.by_id.get(src)
            if node is None or node.name != name:
                continue
            if subtype is not None and (len(node.properties) < 3
                                        or node.properties[2] != subtype):
                continue
            out.append((src, node, prop))
        return out


def _extract_geometry(geom: FBXNode):
    """(MeshData|None, tris control-point indices) for one Geometry node."""
    vnode = geom.find("Vertices")
    inode = geom.find("PolygonVertexIndex")
    if vnode is None or inode is None:
        return None, None
    verts = np.asarray(vnode.properties[0], np.float64).reshape(-1, 3)
    tris, slots = _triangulate(np.asarray(inode.properties[0], np.int64))

    nvals, nmap, nidx = _layer_values(
        geom, "LayerElementNormal", "Normals", "NormalsIndex", 3)
    uvals, umap, uidx = _layer_values(
        geom, "LayerElementUV", "UV", "UVIndex", 2)

    # Expand to per-triangle-corner vertices (the reference flattens
    # polygon-vertex attributes the same way, fbx.cpp geometry pass).
    pos = verts[tris.reshape(-1)]

    def fetch(vals, mapping, idx, width):
        if vals is None:
            return np.zeros((len(pos), width), np.float32)
        if mapping == "ByPolygonVertex":
            sel = slots.reshape(-1)
            if idx is not None:
                sel = idx[sel]
            return vals[sel].astype(np.float32)
        if mapping == "ByVertice" or mapping == "ByVertex":
            sel = tris.reshape(-1)
            if idx is not None:
                sel = idx[sel]
            return vals[sel].astype(np.float32)
        if mapping == "AllSame":
            return np.tile(vals[0], (len(pos), 1)).astype(np.float32)
        raise ValueError(f"unsupported FBX mapping {mapping!r}")

    normals = fetch(nvals, nmap, nidx, 3)
    uvs = fetch(uvals, umap, uidx, 2)
    indices = np.arange(len(pos), dtype=np.int32).reshape(-1, 3)
    mesh = MeshData(pos.astype(np.float32), normals, uvs, indices)
    if nvals is None:
        mesh = generate_normals(mesh)
    return mesh, tris.reshape(-1)


def _extract_skeleton(doc: _Doc):
    """LimbNode hierarchy -> LoadedSkeleton + model-id -> joint-index map.

    Bind local transforms come from the Model's Lcl Translation/Rotation (+
    PreRotation) — the node pose at file time.  The reference derives the
    same pose from cluster TransformLink matrices (fbx.cpp skin section);
    for exports whose bind pose equals the node pose (the normal case) the
    two agree."""
    from .loaders import LoadedSkeleton

    limb_ids = [
        oid for oid, node in doc.by_id.items()
        if node.name == "Model" and len(node.properties) >= 3
        and node.properties[2] == "LimbNode"
    ]
    if not limb_ids:
        return None, {}

    # Include non-limb ancestors that chain limb nodes together.
    ids = set(limb_ids)
    for oid in limb_ids:
        cur = oid
        while True:
            parents = [p for p, _ in doc.parents_of.get(cur, [])
                       if p in doc.by_id and doc.by_id[p].name == "Model"]
            if not parents:
                break
            cur = parents[0]
            ids.add(cur)

    # Topological order (parents first).
    parent_of = {}
    for oid in ids:
        ps = [p for p, _ in doc.parents_of.get(oid, []) if p in ids]
        parent_of[oid] = ps[0] if ps else -1
    ordered: List[int] = []
    seen = set()

    def visit(oid):
        if oid in seen:
            return
        p = parent_of[oid]
        if p != -1:
            visit(p)
        seen.add(oid)
        ordered.append(oid)

    for oid in sorted(ids):
        visit(oid)

    joint_of = {oid: j for j, oid in enumerate(ordered)}
    names, parents, bp, br = [], [], [], []
    for oid in ordered:
        node = doc.by_id[oid]
        p = _props70(node)
        t = np.asarray(p.get("Lcl Translation", [0, 0, 0])[-3:], np.float64)
        r = np.asarray(p.get("Lcl Rotation", [0, 0, 0])[-3:], np.float64)
        pre = p.get("PreRotation")
        q = _euler_deg_to_quat(r)
        if pre is not None:
            q = _qmul_np_fbx(_euler_deg_to_quat(pre[-3:]), q)
        names.append(str(node.properties[1]).split("::")[-1]
                     if len(node.properties) > 1 else f"joint{len(names)}")
        parents.append(joint_of.get(parent_of[oid], -1))
        bp.append(t)
        br.append(q)
    skel = LoadedSkeleton(
        names=names, parents=parents,
        bind_local_pos=np.asarray(bp, np.float32),
        bind_local_rot=np.asarray(br, np.float32),
    )
    return skel, joint_of


def _qmul_np_fbx(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ])


def _extract_skin(doc: _Doc, geom_id: int, joint_of, num_cp: int):
    """Deformer(Skin) -> per-control-point 4-influence table, or None.

    Reference: fbx.cpp skin clusters — Indexes/Weights per cluster, bone
    model linked through the cluster."""
    from .loaders import SkinData

    skins = doc.children(geom_id, "Deformer", "Skin")
    if not skins:
        return None
    skin_id = skins[0][0]
    influences: List[List[Tuple[int, float]]] = [[] for _ in range(num_cp)]
    for cl_id, cluster, _ in doc.children(skin_id, "Deformer", "Cluster"):
        bones = [src for src, prop in doc.children_of.get(cl_id, [])
                 if src in joint_of]
        if not bones:
            continue
        j = joint_of[bones[0]]
        idx_node = cluster.find("Indexes")
        w_node = cluster.find("Weights")
        if idx_node is None or w_node is None:
            continue
        cps = np.asarray(idx_node.properties[0], np.int64)
        ws = np.asarray(w_node.properties[0], np.float64)
        for cp, wgt in zip(cps, ws):
            influences[int(cp)].append((j, float(wgt)))

    ji = np.zeros((num_cp, 4), np.int32)
    jw = np.zeros((num_cp, 4), np.float32)
    for cp, infl in enumerate(influences):
        infl = sorted(infl, key=lambda t: -t[1])[:4]
        for k, (j, wgt) in enumerate(infl):
            ji[cp, k] = j
            jw[cp, k] = wgt
        s = jw[cp].sum()
        if s > 0:
            jw[cp] /= s
    return SkinData(joint_indices=ji, joint_weights=jw)


def _curve_sampler(curve: FBXNode):
    """AnimationCurve -> (times_sec, values) linear sampler arrays."""
    kt = curve.find("KeyTime")
    kv = curve.find("KeyValueFloat")
    if kt is None or kv is None:
        return None
    t = np.asarray(kt.properties[0], np.float64) / KTIME_PER_SEC
    v = np.asarray(kv.properties[0], np.float64)
    return t, v


def _extract_animation(doc: _Doc, skel, joint_of, fps: float = 30.0):
    """AnimationCurveNode/AnimationCurve graph -> LoadedClip (uniform grid).

    Reference: fbx.cpp animation-curve section; resampling to a uniform key
    grid is this build's import-time policy (animation/animation.py)."""
    from .loaders import LoadedClip

    # joint -> {"T"|"R"|"S" -> {"X"|"Y"|"Z" -> (times, values)}}
    tracks: Dict[int, Dict[str, Dict[str, Tuple[np.ndarray, np.ndarray]]]] = {}
    t_min, t_max = np.inf, -np.inf
    prop_kind = {"Lcl Translation": "T", "Lcl Rotation": "R",
                 "Lcl Scaling": "S"}
    for cn_id, cn in list(doc.by_id.items()):
        if cn.name != "AnimationCurveNode":
            continue
        # Which model + which property does this node drive?
        target = None
        for dst, prop in doc.parents_of.get(cn_id, []):
            if prop in prop_kind and dst in joint_of:
                target = (joint_of[dst], prop_kind[prop])
        if target is None:
            continue
        j, kind = target
        for src, prop in doc.children_of.get(cn_id, []):
            node = doc.by_id.get(src)
            if node is None or node.name != "AnimationCurve" or prop is None:
                continue
            chan = prop.split("|")[-1]          # d|X -> X
            samp = _curve_sampler(node)
            if samp is None:
                continue
            tracks.setdefault(j, {}).setdefault(kind, {})[chan] = samp
            t_min = min(t_min, samp[0][0])
            t_max = max(t_max, samp[0][-1])

    if not tracks or not np.isfinite(t_min):
        return None

    duration = max(t_max - t_min, 1.0 / fps)
    k = max(int(round(duration * fps)) + 1, 2)
    grid = np.linspace(t_min, t_max, k)

    nj = len(skel.parents)
    positions = np.tile(skel.bind_local_pos[:, None], (1, k, 1)).astype(np.float64)
    rotations = np.tile(skel.bind_local_rot[:, None], (1, k, 1)).astype(np.float64)
    scales = np.ones((nj, k), np.float64)

    for j, kinds in tracks.items():
        node_pre = None
        # PreRotation must compose with animated Euler like the bind pose.
        for oid, jj in joint_of.items():
            if jj == j:
                pre = _props70(doc.by_id[oid]).get("PreRotation")
                if pre is not None:
                    node_pre = _euler_deg_to_quat(pre[-3:])
        for kind, chans in kinds.items():
            vals = {}
            for c in ("X", "Y", "Z"):
                if c in chans:
                    t, v = chans[c]
                    vals[c] = np.interp(grid, t, v)
            if kind == "T":
                for ci, c in enumerate(("X", "Y", "Z")):
                    if c in vals:
                        positions[j, :, ci] = vals[c]
            elif kind == "S":
                sx = vals.get("X", np.ones(k))
                scales[j] = sx
            elif kind == "R":
                e = np.stack([
                    vals.get("X", np.zeros(k)),
                    vals.get("Y", np.zeros(k)),
                    vals.get("Z", np.zeros(k)),
                ], -1)
                qs = np.stack([_euler_deg_to_quat(e[i]) for i in range(k)])
                if node_pre is not None:
                    qs = np.stack([_qmul_np_fbx(node_pre, q) for q in qs])
                # Hemisphere continuity for nlerp sampling.
                for i in range(1, k):
                    if np.dot(qs[i], qs[i - 1]) < 0:
                        qs[i] = -qs[i]
                rotations[j] = qs

    return LoadedClip(
        name="take", positions=positions.astype(np.float32),
        rotations=rotations.astype(np.float32),
        scales=scales.astype(np.float32), duration=float(duration),
    )


def load_fbx(path: str) -> ModelAsset:
    """Binary or ASCII FBX -> ModelAsset with meshes, skins, skeleton, clips
    (reference: src/asset/fbx.cpp — full binary+ASCII importer)."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(MAGIC):
        root, _ = parse_fbx(data)
    else:
        root = parse_fbx_ascii(data.decode("utf-8", "replace"))
    doc = _Doc(root)

    asset = ModelAsset(materials=[LoadedMaterial(name="default")])
    skel, joint_of = _extract_skeleton(doc)
    if skel is not None:
        asset.skeletons.append(skel)

    for geom in doc.objects.find_all("Geometry"):
        mesh, cp_of_vertex = _extract_geometry(geom)
        if mesh is None:
            continue
        asset.meshes.append(mesh)
        asset.mesh_material.append(0)
        skin = None
        if skel is not None and geom.properties:
            geom_id = int(geom.properties[0])
            vnode = geom.find("Vertices")
            num_cp = len(np.asarray(vnode.properties[0]).reshape(-1, 3))
            cp_skin = _extract_skin(doc, geom_id, joint_of, num_cp)
            if cp_skin is not None:
                from .loaders import SkinData
                skin = SkinData(
                    joint_indices=cp_skin.joint_indices[cp_of_vertex],
                    joint_weights=cp_skin.joint_weights[cp_of_vertex],
                )
        asset.mesh_skin.append(skin)

    if skel is not None:
        clip = _extract_animation(doc, skel, joint_of)
        if clip is not None:
            asset.animations.append(clip)
    return asset


# --------------------------------------------------------------------------
# Minimal writer (round-trip testing, like the reference's debug dumps)
# --------------------------------------------------------------------------

def _write_property(p) -> bytes:
    if isinstance(p, str):
        b = p.encode()
        return b"S" + struct.pack("<I", len(b)) + b
    if isinstance(p, (int, np.integer)):
        return b"L" + struct.pack("<q", int(p))
    if isinstance(p, float):
        return b"D" + struct.pack("<d", p)
    if isinstance(p, np.ndarray):
        code = {np.dtype(np.float64): b"d", np.dtype(np.int32): b"i",
                np.dtype(np.int64): b"l", np.dtype(np.float32): b"f"}[p.dtype]
        raw = p.tobytes()
        comp = zlib.compress(raw)
        return (code + struct.pack("<III", p.size, 1, len(comp)) + comp)
    raise TypeError(type(p))


def _write_node(node: FBXNode, offset: int) -> bytes:
    props = b"".join(_write_property(p) for p in node.properties)
    kids = b""
    name = node.name.encode()
    header_len = 13 + len(name)
    body_start = offset + header_len + len(props)
    if node.children:
        pos = body_start
        for c in node.children:
            blob = _write_node(c, pos)
            kids += blob
            pos += len(blob)
        kids += b"\x00" * 13  # null terminator record
    end = body_start + len(kids)
    return (struct.pack("<III", end, len(node.properties), len(props))
            + bytes([len(name)]) + name + props + kids)


def _p70(entries) -> FBXNode:
    node = FBXNode("Properties70")
    for name, vals in entries:
        node.children.append(FBXNode(
            "P", [name, name, "", "A"] + [float(v) for v in vals]))
    return node


def write_fbx_skinned(path: str, positions, indices,
                      joints, skin_clusters, anim_rot_tracks=None,
                      fps: float = 30.0, anim_pos_tracks=None):
    """Write a binary FBX with a skinned mesh + optional rotation animation
    (round-trip testing for the skin/animation import paths).

    joints: [(name, parent_index, lcl_translation, lcl_rotation_deg)]
    skin_clusters: [(joint_index, control_point_indices, weights)]
    anim_rot_tracks: {joint_index: (times_sec, euler_deg (K, 3))}
    anim_pos_tracks: {joint_index: (times_sec, translation (K, 3))}, the
    Lcl Translation curves the importer reads; without them the file is
    the JAX package writer's, byte for byte.
    """
    poly = []
    for tri in indices:
        poly += [int(tri[0]), int(tri[1]), ~int(tri[2])]

    geom_id = 1000001
    skin_id = 2000001
    geom = FBXNode("Geometry", [geom_id, "Geometry::mesh", "Mesh"])
    geom.children.append(FBXNode(
        "Vertices", [np.asarray(positions, np.float64).reshape(-1)]))
    geom.children.append(FBXNode(
        "PolygonVertexIndex", [np.asarray(poly, np.int32)]))

    objects = FBXNode("Objects")
    objects.children.append(geom)
    conns = FBXNode("Connections")

    mesh_model_id = 3000000
    mesh_model = FBXNode("Model", [mesh_model_id, "Model::mesh", "Mesh"])
    objects.children.append(mesh_model)
    conns.children.append(FBXNode("C", ["OO", geom_id, mesh_model_id]))

    model_ids = []
    for ji, (name, parent, t, r) in enumerate(joints):
        mid = 3000001 + ji
        model_ids.append(mid)
        node = FBXNode("Model", [mid, f"Model::{name}", "LimbNode"])
        node.children.append(_p70([
            ("Lcl Translation", t), ("Lcl Rotation", r),
        ]))
        objects.children.append(node)
        dst = model_ids[parent] if parent >= 0 else 0
        conns.children.append(FBXNode("C", ["OO", mid, dst]))

    skin = FBXNode("Deformer", [skin_id, "Deformer::skin", "Skin"])
    objects.children.append(skin)
    conns.children.append(FBXNode("C", ["OO", skin_id, geom_id]))
    for k, (ji, cps, ws) in enumerate(skin_clusters):
        cid = 2000100 + k
        cl = FBXNode("Deformer", [cid, f"Deformer::cl{k}", "Cluster"])
        cl.children.append(FBXNode("Indexes", [np.asarray(cps, np.int32)]))
        cl.children.append(FBXNode("Weights", [np.asarray(ws, np.float64)]))
        objects.children.append(cl)
        conns.children.append(FBXNode("C", ["OO", cid, skin_id]))
        conns.children.append(FBXNode("C", ["OO", model_ids[ji], cid]))

    if anim_rot_tracks:
        for k, (ji, (times, eulers)) in enumerate(anim_rot_tracks.items()):
            cn_id = 4000000 + k
            cn = FBXNode("AnimationCurveNode", [cn_id, "AnimCurveNode::R", ""])
            objects.children.append(cn)
            conns.children.append(FBXNode(
                "C", ["OP", cn_id, model_ids[ji], "Lcl Rotation"]))
            kt = (np.asarray(times, np.float64) * KTIME_PER_SEC).astype(np.int64)
            eu = np.asarray(eulers, np.float64)
            for ci, chan in enumerate(("X", "Y", "Z")):
                cv_id = 4100000 + k * 3 + ci
                cv = FBXNode("AnimationCurve", [cv_id, "AnimCurve::", ""])
                cv.children.append(FBXNode("KeyTime", [kt]))
                cv.children.append(FBXNode(
                    "KeyValueFloat", [eu[:, ci].astype(np.float32)]))
                objects.children.append(cv)
                conns.children.append(FBXNode(
                    "C", ["OP", cv_id, cn_id, f"d|{chan}"]))

    for k, (ji, (times, values)) in enumerate((anim_pos_tracks or {}).items()):
        cn_id = 4200000 + k
        cn = FBXNode("AnimationCurveNode", [cn_id, "AnimCurveNode::T", ""])
        objects.children.append(cn)
        conns.children.append(FBXNode(
            "C", ["OP", cn_id, model_ids[ji], "Lcl Translation"]))
        kt = (np.asarray(times, np.float64) * KTIME_PER_SEC).astype(np.int64)
        vals = np.asarray(values, np.float64)
        for ci, chan in enumerate(("X", "Y", "Z")):
            cv_id = 4300000 + k * 3 + ci
            cv = FBXNode("AnimationCurve", [cv_id, "AnimCurve::", ""])
            cv.children.append(FBXNode("KeyTime", [kt]))
            cv.children.append(FBXNode(
                "KeyValueFloat", [vals[:, ci].astype(np.float32)]))
            objects.children.append(cv)
            conns.children.append(FBXNode(
                "C", ["OP", cv_id, cn_id, f"d|{chan}"]))

    blob = MAGIC + struct.pack("<I", 7400)
    pos = len(blob)
    for top in [objects, conns]:
        node_blob = _write_node(top, pos)
        blob += node_blob
        pos += len(node_blob)
    blob += b"\x00" * 13
    with open(path, "wb") as f:
        f.write(blob)


def write_fbx_geometry(path: str, positions: np.ndarray, indices: np.ndarray,
                       normals: Optional[np.ndarray] = None,
                       uvs: Optional[np.ndarray] = None):
    """Write a minimal version-7400 binary FBX with one Geometry node."""
    poly = []
    for tri in indices:
        poly += [int(tri[0]), int(tri[1]), ~int(tri[2])]

    geom = FBXNode("Geometry", [1000001, "Geometry::mesh", "Mesh"])
    geom.children.append(FBXNode(
        "Vertices", [np.asarray(positions, np.float64).reshape(-1)]))
    geom.children.append(FBXNode(
        "PolygonVertexIndex", [np.asarray(poly, np.int32)]))
    if normals is not None:
        layer = FBXNode("LayerElementNormal", [0])
        layer.children.append(FBXNode("MappingInformationType", ["ByVertice"]))
        layer.children.append(FBXNode(
            "Normals", [np.asarray(normals, np.float64).reshape(-1)]))
        geom.children.append(layer)
    if uvs is not None:
        layer = FBXNode("LayerElementUV", [0])
        layer.children.append(FBXNode("MappingInformationType", ["ByVertice"]))
        layer.children.append(FBXNode(
            "UV", [np.asarray(uvs, np.float64).reshape(-1)]))
        geom.children.append(layer)

    objects = FBXNode("Objects")
    objects.children.append(geom)

    blob = MAGIC + struct.pack("<I", 7400)
    pos = len(blob)
    for top in [objects]:
        node_blob = _write_node(top, pos)
        blob += node_blob
        pos += len(node_blob)
    blob += b"\x00" * 13
    with open(path, "wb") as f:
        f.write(blob)
