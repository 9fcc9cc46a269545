"""Procedural placement on terrain (counterpart of
``d3d12renderer_tpu/terrain/placement.py``): a jittered grid of points with
height, slope and density masks, and a stable partition order standing in
for prefix-sum compaction (valid points first, fixed shapes).

The JAX module draws from `jax.random`; here every draw comes from a
`torch.Generator` (the scene's set-up takes a CPU generator: a stream
depends on its device), or from `draws`, as the tests inject the JAX
package's.  Draws are uniforms in [0, 1):

* points: `{"jitter": (N, 2), "rotation": (N,), "scale": (N,),
  "density": (N,)}` (N = points_per_side^2), taken from the generator in
  that order;
* layers: `{"points": <points' draws>, "layers": [{"density": (N,),
  "choice": (N,)}, ...]}`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .heightmap import sample_height_bilinear

# jax.random.uniform(key, minval=0.7, maxval=1.3): u * (max - min) + min in
# float32.
_SCALE_LO = np.float32(0.7)
_SCALE_SPAN = float(np.float32(1.3) - np.float32(0.7))


def draw_points(n: int, generator=None, device="cpu"):
    """The uniforms of `generate_placement_points` for `n` points."""
    def u(*shape):
        return torch.rand(shape, generator=generator, device=device)

    return {"jitter": u(n, 2), "rotation": u(n), "scale": u(n),
            "density": u(n)}


def _f32(x, device):
    return torch.as_tensor(np.array(x, np.float32), device=device)


def generate_placement_points(heights, origin, cell_size: float,
                              world_size: float, generator=None,
                              points_per_side: int = 64,
                              min_height: float = -1e9,
                              max_height: float = 1e9,
                              max_slope_y: float = 0.7, density: float = 1.0,
                              draws=None):
    """Points on an (R, R) heightmap tensor: dict of position (N, 3),
    normal (N, 3), rotation (N,) in [0, 2 pi), scale (N,) in [0.7, 1.3),
    valid (N,), count () and order (N,) (valid indices first, stable)."""
    n = points_per_side
    dev = heights.device
    if draws is None:
        draws = draw_points(n * n, generator, dev)
    d = {k: _f32(v, dev) for k, v in draws.items()}
    cell = world_size / n
    ii, jj = torch.meshgrid(torch.arange(n, device=dev),
                            torch.arange(n, device=dev), indexing="ij")
    ij = torch.stack([ii, jj], -1).reshape(-1, 2).to(torch.float32)
    xz = (ij + d["jitter"]) * cell
    x = origin[0] + xz[:, 0]
    z = origin[2] + xz[:, 1]
    h, normal = sample_height_bilinear(heights, origin, cell_size, x, z)
    keep = ((h >= min_height) & (h <= max_height)
            & (normal[:, 1] >= max_slope_y) & (d["density"] < density))
    scale = torch.clamp(d["scale"] * _SCALE_SPAN + float(_SCALE_LO),
                        min=float(_SCALE_LO))
    return {
        "position": torch.stack([x, h, z], -1),
        "normal": normal,
        "rotation": d["rotation"] * 2 * math.pi,
        "scale": scale,
        "valid": keep,
        "count": keep.sum(),
        "order": _valid_first(keep),
    }


def _valid_first(keep):
    """Indices with the valid ones first, each group in index order
    (`jnp.argsort(~keep, stable=True)`)."""
    return torch.argsort((~keep).to(torch.uint8), stable=True)


def generate_placement_layers(heights, origin, cell_size, world_size,
                              layers, generator=None, points_per_side=64,
                              draws=None):
    """Layers of placement on one shared jittered grid; a point belongs to
    at most one layer (earlier layers win).  `layers`: dicts with optional
    min_height / max_height / max_slope_y / density / mesh_weights /
    scale_range.  Returns one dict per layer: `generate_placement_points`'
    fields with the layer's valid / count / order / scale, plus
    `mesh_index` (a weighted choice of the layer's mesh variants)."""
    dev = heights.device
    origin = _f32(origin, dev)
    pts = generate_placement_points(
        heights, origin, cell_size, world_size, generator,
        points_per_side=points_per_side, max_slope_y=-1.0, density=1.0,
        draws=None if draws is None else draws["points"])
    n = pts["position"].shape[0]
    h = pts["position"][:, 1]
    ny = pts["normal"][:, 1]
    claimed = torch.zeros((n,), dtype=torch.bool, device=dev)
    out = []
    for i, layer in enumerate(layers):
        if draws is None:
            u_d = torch.rand(n, generator=generator, device=dev)
            u_c = torch.rand(n, generator=generator, device=dev)
        else:
            u_d = _f32(draws["layers"][i]["density"], dev)
            u_c = _f32(draws["layers"][i]["choice"], dev)
        keep = (pts["valid"] & ~claimed
                & (h >= layer.get("min_height", -1e9))
                & (h <= layer.get("max_height", 1e9))
                & (ny >= layer.get("max_slope_y", 0.7))
                & (u_d < layer.get("density", 1.0)))
        claimed = claimed | keep
        # jax.random.choice with p: searchsorted of cumsum(p) * (1 - u).
        w = _f32(layer.get("mesh_weights", [1.0]), dev)
        p_cuml = torch.cumsum(w / torch.sum(w), 0)
        mesh_index = torch.searchsorted(p_cuml, p_cuml[-1] * (1 - u_c))
        lo, hi = layer.get("scale_range", (0.7, 1.3))
        scale = lo + (hi - lo) * (pts["scale"] - 0.7) / 0.6
        out.append({**pts, "valid": keep, "count": keep.sum(),
                    "order": _valid_first(keep), "mesh_index": mesh_index,
                    "scale": scale})
    return out


def instantiate_placement(layer, mesh_builders, material_ids=None,
                          max_instances=None):
    """One layer expanded on the host into transformed meshes
    [(MeshData, material)] for `build_bvh`: the first `max_instances` valid
    points in order, each mesh variant (a MeshData or a zero-argument
    callable, chosen by `mesh_index`) turned about +y and scaled."""
    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else \
            np.asarray(x)

    valid = host(layer["valid"])
    order = host(layer["order"])[: int(valid.sum())]
    if max_instances is not None:
        order = order[:max_instances]
    pos, rot = host(layer["position"]), host(layer["rotation"])
    scl, midx = host(layer["scale"]), host(layer["mesh_index"])
    protos = [b() if callable(b) else b for b in mesh_builders]
    if material_ids is None:
        material_ids = [0] * len(protos)
    out = []
    for i in order:
        k = int(midx[i]) % len(protos)
        half = np.sin(rot[i] * 0.5)
        quat = (0.0, float(half), 0.0, float(np.cos(rot[i] * 0.5)))
        out.append((protos[k].transformed(translate=tuple(pos[i]),
                                          rotate=quat, scale=float(scl[i])),
                    material_ids[k]))
    return out
