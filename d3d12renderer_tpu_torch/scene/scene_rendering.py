"""Per-entity render submission (counterpart of
``d3d12renderer_tpu/scene/scene_rendering.py``): frustum planes, the
vectorised culling of bounding spheres, and the host-side assembly of a
scene's renderable entities into one instanced triangle buffer whose culled
instances collapse to a point."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..render.camera import Camera
from ..render.instances import build_instanced, retransform
from ..render.mesh import MeshData
from .components import Material, to_plain

# `Material`'s defaults, for entities without a material component.
DEFAULT_MATERIAL = to_plain(Material())


def frustum_planes(camera: Camera):
    """(5, 4) world-space planes (nx, ny, nz, d) with inward normals: near
    (through the camera) and the four sides, in float64 on the host, then
    float32 on the CPU."""
    pos = camera.position.detach().cpu().numpy().astype(np.float64)
    x, y, z, w = camera.rotation.detach().cpu().numpy().astype(np.float64)
    rm = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    right, up, back = rm[:, 0], rm[:, 1], rm[:, 2]
    fwd = -back
    tan_v = math.tan(camera.v_fov / 2)
    tan_h = tan_v * camera.aspect

    def plane(n):
        n = n / np.linalg.norm(n)
        return np.concatenate([n, [-n @ pos]])

    dir_r = fwd + right * tan_h
    dir_l = fwd - right * tan_h
    dir_t = fwd + up * tan_v
    dir_b = fwd - up * tan_v
    planes = [plane(fwd), plane(np.cross(up, dir_r)),
              plane(np.cross(dir_l, up)), plane(np.cross(dir_t, right)),
              plane(np.cross(right, dir_b))]
    return torch.as_tensor(np.stack(planes).astype(np.float32))


def cull_spheres(planes, centers, radii):
    """(I,) visibility of bounding spheres against the planes."""
    d = torch.einsum("pk,ik->pi", planes[:, :3], centers) + planes[:, 3:4]
    return torch.all(d > -radii[None, :], dim=0)


class RenderSubmission:
    """The draw set of a scene's entities with a transform and a mesh
    primitive: one instanced buffer (`render.instances`), one material
    per entity, a bounding radius per instance.  `scene` is any object with
    `view(*kinds)` yielding `(entity, components)` and `entity(id).get(kind)`
    (`scene.scene.Scene`)."""

    def __init__(self, scene, device="cuda"):
        from ..cuda_build import resolve_device
        from ..render.pathtracer import Materials

        self.device = resolve_device(device)
        prims = self._prims()
        self.entity_ids: List[int] = []
        meshes: List[Tuple[MeshData, int]] = []
        instance_mesh: List[int] = []
        mats: List[Dict] = []
        bound_radius: List[float] = []
        for ent, (tf, mesh) in scene.view("transform", "mesh"):
            if mesh.primitive is None:
                continue
            mat = ent.get("material")
            mat = DEFAULT_MATERIAL if mat is None else {
                k: getattr(mat, k) for k in DEFAULT_MATERIAL}
            geo = prims[mesh.primitive](**mesh.params)
            instance_mesh.append(len(meshes))
            meshes.append((geo, len(mats)))
            mats.append(mat)
            self.entity_ids.append(ent.id)
            bound_radius.append(
                float(np.linalg.norm(geo.positions, axis=-1).max())
                * float(tf.scale))

        def f32(key):
            return torch.as_tensor(np.array([mt[key] for mt in mats],
                                            np.float32), device=self.device)

        self.instanced = build_instanced(meshes, instance_mesh, self.device)
        self.materials = Materials(albedo=f32("albedo"),
                                   emissive=f32("emissive"),
                                   roughness=f32("roughness"),
                                   metallic=f32("metallic"))
        self.bound_radius = torch.as_tensor(
            np.array(bound_radius, np.float32), device=self.device)
        self._static_pose = self._poses_from_scene(scene)

    @staticmethod
    def _prims():
        from ..render import mesh as mesh_mod

        return {
            "quad": mesh_mod.quad, "box": mesh_mod.box,
            "sphere": mesh_mod.ico_sphere, "uv_sphere": mesh_mod.uv_sphere,
            "capsule": mesh_mod.capsule, "cylinder": mesh_mod.cylinder,
            "torus": mesh_mod.torus, "arrow": mesh_mod.arrow,
            "mace": mesh_mod.mace, "hollow_cylinder": mesh_mod.hollow_cylinder,
        }

    def _poses_from_scene(self, scene):
        pos, rot = [], []
        for eid in self.entity_ids:
            tf = scene.entity(eid).get("transform")
            pos.append(tf.position)
            rot.append(tf.rotation)
        return tuple(torch.as_tensor(np.array(x, np.float32),
                                     device=self.device) for x in (pos, rot))

    def instance_poses(self, body_state=None, mapping=None):
        """Instance poses: entities in `mapping` (entity id -> body index)
        take the bodies' poses (`body_state.pos` (N, 3), `.rot` (N, 4)),
        the rest their transforms."""
        pos, rot = self._static_pose
        if body_state is not None and mapping:
            idx = np.array([mapping.get(eid, -1) for eid in self.entity_ids],
                           np.int64)
            has = torch.as_tensor(idx >= 0, device=self.device)
            gather = torch.as_tensor(np.maximum(idx, 0), device=self.device)
            pos = torch.where(has[:, None], body_state.pos[gather], pos)
            rot = torch.where(has[:, None], body_state.rot[gather], rot)
        return pos, rot

    def visible_bvh(self, camera: Camera, pos, rot):
        """The frustum-culled BVH of the instances at `pos` / `rot`, culled
        instances collapsed to a point (scale 0), and the visibility."""
        planes = frustum_planes(camera).to(self.device)
        vis = cull_spheres(planes, pos, self.bound_radius)
        scale = torch.where(vis, 1.0, 0.0)
        return (retransform(self.instanced, pos, rot, scales=scale, tree=True),
                vis)
