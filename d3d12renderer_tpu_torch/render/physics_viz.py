"""Render a physics scene from its collider tables (counterpart of
``d3d12renderer_tpu/render/physics_viz.py``): every collider as a
primitive mesh at its simulated world pose, horizontal planes as a ground
quad, one BVH, one path-traced frame: the eval render of the locomotion
training (BASELINE config 5)."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..physics.collide import collider_world_poses
from ..physics.types import (SHAPE_BOX, SHAPE_CAPSULE, SHAPE_CYLINDER,
                             SHAPE_HULL, SHAPE_SPHERE, BodyState,
                             SceneArchetype)
from . import bvh as bvh_mod
from . import mesh as mesh_mod


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def physics_meshes(arch: SceneArchetype, state: BodyState,
                   material_of=None, ground_material: int = 0):
    """[(MeshData, material_id)] for every collider of one scene (`state`
    unbatched: (N, 3) positions), plus a quad for each horizontal plane.
    material_of(collider_index) -> material id; by default 1 + body index
    mod 4, so that neighbouring bodies alternate."""
    batched = BodyState(*(x[None] for x in (state.pos, state.rot, state.vel,
                                            state.omega, state.force,
                                            state.torque)))
    wpos, wrot = (_host(x[0]) for x in collider_world_poses(arch, batched))
    col_type, size, body = (_host(x) for x in (arch.col_type, arch.col_size,
                                               arch.col_body))
    hull_v, hull_m = _host(arch.col_hull_verts), _host(arch.col_hull_mask)

    meshes = []
    for ci in range(col_type.shape[0]):
        t = int(col_type[ci])
        if t == SHAPE_SPHERE:
            geo = mesh_mod.ico_sphere(float(size[ci, 0]), 2)
        elif t == SHAPE_BOX:
            geo = mesh_mod.box(tuple(size[ci]))
        elif t == SHAPE_CAPSULE:
            geo = mesh_mod.capsule(float(size[ci, 0]), float(size[ci, 1]))
        elif t == SHAPE_CYLINDER:
            geo = mesh_mod.cylinder(float(size[ci, 0]), float(size[ci, 1]))
        elif t == SHAPE_HULL:
            pts = hull_v[ci][hull_m[ci]]
            r = float(np.linalg.norm(pts, axis=-1).max()) if len(pts) else 0.1
            geo = mesh_mod.ico_sphere(r, 1)   # hulls: bounding-sphere proxy
        else:
            continue
        geo = geo.transformed(translate=tuple(wpos[ci]),
                              rotate=tuple(wrot[ci]))
        mat = material_of(ci) if material_of else 1 + int(body[ci]) % 4
        meshes.append((geo, mat))

    plane_n, plane_off = _host(arch.plane_normal), _host(arch.plane_offset)
    for pi in range(plane_n.shape[0]):
        n = plane_n[pi]
        if abs(n[1]) > 0.9:   # horizontal ground plane -> big quad
            q = mesh_mod.quad(half=30.0).transformed(
                translate=(0.0, float(plane_off[pi] / max(n[1], 1e-6)), 0.0))
            meshes.append((q, ground_material))
    return meshes


def render_physics_state(arch: SceneArchetype, state: BodyState,
                         eye=(6.0, 4.0, 8.0), target=(0.0, 1.0, 0.0),
                         size: int = 256, spp: int = 8, sampler=None,
                         materials=None):
    """Path-trace one frame of one scene's physics state on its device:
    (size, size, 3) uint8 through `to_srgb_u8`, depth 2, `spp` samples per
    pixel drawn from `sampler` (a `pathtracer.Sampler`; by default one
    seeded 0)."""
    from .camera import look_at
    from .pathtracer import (Materials, PathTracerSettings, Sampler, Scene,
                             default_sky, render, to_srgb_u8)

    dev = state.pos.device
    b = bvh_mod.build_bvh(physics_meshes(arch, state), device=dev)
    if materials is None:
        materials = Materials(
            albedo=torch.tensor([[0.55, 0.55, 0.55], [0.8, 0.3, 0.25],
                                 [0.25, 0.5, 0.8], [0.85, 0.7, 0.25],
                                 [0.4, 0.75, 0.35]], device=dev),
            emissive=torch.zeros((5, 3), device=dev),
            roughness=torch.full((5,), 0.55, device=dev),
            metallic=torch.zeros((5,), device=dev))
    scene = Scene(bvh=b, materials=materials,
                  sky=default_sky(device=dev)).with_shading_table()
    cam = look_at(eye, target, device=dev, aspect=1.0,
                  v_fov=math.radians(50))
    if sampler is None:
        sampler = Sampler(torch.Generator(device=dev).manual_seed(0))
    img, _ = render(scene, cam, size, size,
                    PathTracerSettings(recursion_depth=2), spp=spp,
                    sampler=sampler)
    return _host(to_srgb_u8(img))
