"""Entity scene: the ECS-equivalent authoring layer (counterpart of
``d3d12renderer_tpu/scene/scene.py``).

Replaces the reference's EnTT-backed game_scene (reference:
src/scene/scene.h:231-385 — createEntity/addComponent/view/clone) with a
host-side registry whose `compile_physics` / `build_render_scene` lower
everything into the fixed-shape device tables (the port's `SceneArchetype`
and `BodyState`, the path tracer's `Scene`) on a device.

Component hooks fire on add_component like the reference's EnTT hooks
(scene.h:38-94): colliders accumulate per entity, joints become a list.

Serialization: YAML save/load of the full entity description (reference:
src/scene/serialization_yaml.cpp:363,454) through PyYAML in the JAX
package's layout, so a file written by either package reads back in the
other.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np

from . import components as C


class Entity:
    """Handle into a Scene (reference: scene_entity, src/scene/scene.h:26)."""

    def __init__(self, scene: "Scene", eid: int):
        self.scene = scene
        self.id = eid

    def add_component(self, comp) -> "Entity":
        kind = comp.component_name
        store = self.scene._components.setdefault(kind, {})
        if kind in ("collider", "joint"):
            store.setdefault(self.id, []).append(comp)
        else:
            store[self.id] = comp
        return self

    def get(self, kind: str):
        return self.scene._components.get(kind, {}).get(self.id)

    def has(self, kind: str) -> bool:
        return self.id in self.scene._components.get(kind, {})

    @property
    def name(self) -> str:
        return self.scene._names.get(self.id, f"entity{self.id}")

    def __repr__(self):
        return f"Entity({self.name})"


def _scene0(x):
    """The first scene's rows of a batched (B, N, k) state tensor, as
    float32 numpy on the host."""
    x = x[0] if x.dim() == 3 else x
    return x.detach().cpu().numpy()


class Scene:
    """reference: game_scene (src/scene/scene.h:231)."""

    def __init__(self):
        self._next_id = 0
        self._entities: List[int] = []
        self._names: Dict[int, str] = {}
        self._components: Dict[str, Dict[int, Any]] = {}
        self.planes: List[Tuple] = []  # static world planes

    # -- entity management (reference: scene.h createEntity/deleteEntity) ----

    def create_entity(self, name: str = "") -> Entity:
        eid = self._next_id
        self._next_id += 1
        self._entities.append(eid)
        self._names[eid] = name or f"entity{eid}"
        return Entity(self, eid)

    def delete_entity(self, entity: Entity):
        self._entities.remove(entity.id)
        self._names.pop(entity.id, None)
        for store in self._components.values():
            store.pop(entity.id, None)

    def entity(self, eid: int) -> Entity:
        return Entity(self, eid)

    def add_static_plane(self, normal, offset, friction=0.8, restitution=0.0):
        self.planes.append((tuple(normal), float(offset), friction,
                            restitution))

    # -- views (reference: scene.h view/group) -------------------------------

    def view(self, *kinds: str) -> Iterator[Tuple[Entity, tuple]]:
        """Iterate entities having ALL the given component kinds."""
        if not kinds:
            for eid in self._entities:
                yield Entity(self, eid), ()
            return
        stores = [self._components.get(k, {}) for k in kinds]
        for eid in self._entities:
            if all(eid in s for s in stores):
                yield Entity(self, eid), tuple(s[eid] for s in stores)

    def count(self, kind: str) -> int:
        return len(self._components.get(kind, {}))

    # -- play-mode cloning (reference: scene.h:359 cloneTo) ------------------

    def clone(self) -> "Scene":
        return copy.deepcopy(self)

    # -- compilation to device tables ----------------------------------------

    def compile_physics(self, device="cuda"):
        """Lower physics components into (SceneArchetype, BodyState,
        mapping) on `device`; the state has a batch axis of 1.

        mapping[entity_id] -> body index; static colliders (no rigid_body)
        attach to a kinematic body."""
        from ..physics.builder import SceneBuilder

        b = SceneBuilder()
        for (n, off, fr, re) in self.planes:
            b.add_static_plane(n, off, fr, re)

        mapping: Dict[int, int] = {}
        for ent, (tf,) in self.view("transform"):
            colliders = ent.get("collider")
            rb = ent.get("rigid_body")
            if not colliders and rb is None:
                continue
            body = b.add_body(
                position=tf.position, rotation=tf.rotation,
                kinematic=(rb.kinematic if rb else True),
                mass=(rb.mass if rb else None),
                gravity_factor=(rb.gravity_factor if rb else 1.0),
                linear_damping=(rb.linear_damping if rb else 0.4),
                angular_damping=(rb.angular_damping if rb else 0.4),
            )
            mapping[ent.id] = body
            for col in colliders or []:
                self._add_collider(b, body, col)

        # Joint components (reference: constraint creation from the editor,
        # physics.cpp:147-330), resolved after every body exists.
        for ent, (tf,) in self.view("transform"):
            for j in ent.get("joint") or []:
                a = mapping.get(ent.id)
                if a is None:
                    raise ValueError(
                        f"entity {ent.name} has a joint but no rigid body")
                if j.other not in mapping:
                    raise ValueError(
                        f"joint on {ent.name}: other entity {j.other} has "
                        f"no rigid body")
                bb = mapping[j.other]
                mtype = 1.0 if j.motor_type == "position" else 0.0
                motor_max = j.motor_max if j.motor_max > 0 else None
                if j.kind == "distance":
                    idx = b.add_distance_joint(
                        a, bb, j.anchor, j.anchor_b or j.anchor,
                        length=j.length)
                elif j.kind == "ball":
                    idx = b.add_ball_joint(a, bb, j.anchor)
                elif j.kind == "fixed":
                    idx = b.add_fixed_joint(a, bb, j.anchor)
                elif j.kind == "hinge":
                    idx = b.add_hinge_joint(
                        a, bb, j.anchor, j.axis,
                        min_limit=j.limit_min, max_limit=j.limit_max,
                        motor_type=mtype, motor_target=j.motor_target,
                        max_torque=motor_max)
                elif j.kind == "cone_twist":
                    idx = b.add_cone_twist_joint(
                        a, bb, j.anchor, j.axis,
                        swing_limit=j.swing_limit,
                        twist_limit=j.twist_limit,
                        twist_motor_type=mtype,
                        twist_target=j.motor_target,
                        max_twist_torque=motor_max)
                elif j.kind == "slider":
                    idx = b.add_slider_joint(
                        a, bb, j.anchor, j.axis,
                        neg_limit=j.limit_min, pos_limit=j.limit_max,
                        motor_type=mtype, motor_target=j.motor_target,
                        max_force=motor_max)
                else:
                    raise ValueError(f"unknown joint kind {j.kind!r}")
                if j.collide_connected:
                    b.set_collide_connected(idx)

        arch, state = b.finalize(device=device)
        return arch, state, mapping

    @staticmethod
    def _add_collider(b, body: int, col: C.Collider):
        s = col.size
        kw = dict(density=col.density, friction=col.friction,
                  restitution=col.restitution)
        if col.shape == "sphere":
            b.add_sphere_collider(body, radius=s[0], center=col.center, **kw)
        elif col.shape == "capsule":
            b.add_capsule_collider(body, radius=s[0], half_length=s[1],
                                   center=col.center, rotation=col.rotation,
                                   **kw)
        elif col.shape == "box":
            b.add_box_collider(body, half_extents=s, center=col.center,
                               rotation=col.rotation, **kw)
        elif col.shape == "cylinder":
            b.add_cylinder_collider(body, radius=s[0], half_length=s[1],
                                    center=col.center, rotation=col.rotation,
                                    **kw)
        elif col.shape == "hull":
            b.add_hull_collider(body, col.points, center=col.center,
                                rotation=col.rotation, **kw)
        else:
            raise ValueError(f"unknown collider shape {col.shape!r}")

    def compile_cloths(self, device="cuda"):
        """(entity id, ClothParams, ClothState) for every cloth component,
        on `device`."""
        from ..physics import cloth as cloth_mod

        out = []
        for ent, (tf, cl) in self.view("transform", "cloth"):
            params, state = cloth_mod.create_cloth(
                cl.width, cl.height, cl.grid_x, cl.grid_y, cl.total_mass,
                cl.stiffness, cl.damping, cl.gravity_factor, cl.fix_top_row,
                device=device)
            offset = state.positions.new_tensor(
                np.asarray(tf.position, np.float32))
            state = state.replace(
                positions=state.positions + offset,
                prev_positions=state.prev_positions + offset)
            out.append((ent.id, params, state))
        return out

    def build_render_scene(self, body_state=None, mapping=None,
                           device="cuda"):
        """Assemble the path tracer's Scene (BVH, Materials, Sky) from
        mesh + material components on `device`.

        With `body_state` + `mapping`, physics-driven entities render at
        their simulated poses (reference: per-frame TLAS rebuild,
        application.cpp:655-665); a batched state gives its first scene."""
        from dataclasses import replace

        import torch

        from ..cuda_build import resolve_device
        from ..render import bvh as bvh_mod
        from ..render.pathtracer import Materials, Scene as RScene
        from ..render.pathtracer import default_sky
        from .scene_rendering import RenderSubmission

        device = resolve_device(device)
        prims = RenderSubmission._prims()
        if body_state is not None and mapping:
            body_pos = _scene0(body_state.pos)
            body_rot = _scene0(body_state.rot)

        mats: List[C.Material] = []
        meshes = []
        for ent, (tf, mesh) in self.view("transform", "mesh"):
            if mesh.primitive is None:
                continue
            mat = ent.get("material") or C.Material()
            geo = prims[mesh.primitive](**mesh.params)
            pos, rot = tf.position, tf.rotation
            if body_state is not None and mapping and ent.id in mapping:
                bi = mapping[ent.id]
                pos, rot = body_pos[bi], body_rot[bi]
            geo = geo.transformed(translate=pos, rotate=rot, scale=tf.scale)
            meshes.append((geo, len(mats)))
            mats.append(mat)

        sun = None
        for ent, (dl,) in self.view("directional_light"):
            sun = dl
        sky = (default_sky(tuple(-d for d in sun.direction), device=device)
               if sun else default_sky(device=device))
        if sun:
            sky = replace(sky, sun_radiance=torch.as_tensor(
                np.asarray(sun.color, np.float32) * np.float32(sun.intensity),
                device=device))

        def f32(key):
            return torch.as_tensor(np.array([getattr(m, key) for m in mats],
                                            np.float32), device=device)

        bvh = bvh_mod.build_bvh(meshes, device=device)
        materials = Materials(albedo=f32("albedo"), emissive=f32("emissive"),
                              roughness=f32("roughness"),
                              metallic=f32("metallic"))
        return RScene(bvh=bvh, materials=materials, sky=sky)

    # -- serialization (reference: serialization_yaml.cpp:363,454) -----------

    def to_document(self) -> dict:
        """The YAML document: planes and entities with their components."""
        doc = {"planes": [list(p[0]) + [p[1], p[2], p[3]]
                          for p in self.planes],
               "entities": []}
        for eid in self._entities:
            ent = {"name": self._names[eid], "components": {}}
            for kind, store in self._components.items():
                if eid not in store:
                    continue
                v = store[eid]
                if kind in ("collider", "joint"):
                    ent["components"][kind] = [C.to_plain(c) for c in v]
                else:
                    ent["components"][kind] = C.to_plain(v)
            doc["entities"].append(ent)
        return doc

    @classmethod
    def from_document(cls, doc: dict) -> "Scene":
        scene = cls()
        for p in doc.get("planes", []):
            scene.add_static_plane(p[:3], p[3], p[4], p[5])
        for ed in doc.get("entities", []):
            ent = scene.create_entity(ed.get("name", ""))
            for kind, data in ed.get("components", {}).items():
                if kind in ("collider", "joint"):
                    for cd in data:
                        ent.add_component(C.from_plain(kind, cd))
                else:
                    ent.add_component(C.from_plain(kind, data))
        return scene

    def save_yaml(self, path: str):
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(self.to_document(), f, sort_keys=False)

    @classmethod
    def load_yaml(cls, path: str) -> "Scene":
        import yaml

        with open(path) as f:
            return cls.from_document(yaml.safe_load(f))
