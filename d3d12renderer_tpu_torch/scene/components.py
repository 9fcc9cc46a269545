"""Component definitions for the entity scene (counterpart of
``d3d12renderer_tpu/scene/components.py``, with its names, fields and
defaults).

Mirrors the reference component set (reference: src/scene/components.h — tag,
transform family; per-subsystem components from scene/scene.h:36-112 collider/
rigid-body/cloth hooks, rendering/light_source.h lights, terrain/water/tree
components).  Components are plain dataclasses: reflection for serialization
and inspection comes free.  Host-only: nothing here touches a device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

_REGISTRY: Dict[str, type] = {}


def component(name: str):
    def wrap(cls):
        cls = dataclass(cls)
        cls.component_name = name
        _REGISTRY[name] = cls
        return cls
    return wrap


def component_class(name: str) -> type:
    return _REGISTRY[name]


def to_plain(comp) -> Dict[str, Any]:
    out = {}
    for f in dataclasses.fields(comp):
        v = getattr(comp, f.name)
        if isinstance(v, np.ndarray):
            v = v.tolist()
        elif isinstance(v, tuple):
            v = list(v)
        out[f.name] = v
    return out


def from_plain(name: str, data: Dict[str, Any]):
    return _REGISTRY[name](**data)


@component("transform")
class Transform:
    """reference: transform_component (= trs, src/core/math.h:494)."""

    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    rotation: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    scale: float = 1.0


@component("dynamic")
class Dynamic:
    """Marker for moving entities (reference: dynamic_transform_component)."""


@component("rigid_body")
class RigidBody:
    """reference: rigid_body_component (src/physics/physics.h)."""

    kinematic: bool = False
    mass: Optional[float] = None
    gravity_factor: float = 1.0
    linear_damping: float = 0.4
    angular_damping: float = 0.4


@component("collider")
class Collider:
    """One collider; entities may hold several (reference: collider_component
    linked list per entity, src/scene/scene.h:38-63)."""

    shape: str = "sphere"            # sphere|capsule|box|cylinder|hull
    size: Tuple[float, ...] = (0.5,)  # shape params (radius / half extents...)
    center: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    rotation: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    points: Optional[List[List[float]]] = None  # hull point cloud
    density: float = 1000.0
    friction: float = 0.5
    restitution: float = 0.0


@component("mesh")
class Mesh:
    """Renderable mesh: procedural primitive or asset path
    (reference: mesh_component, src/geometry/mesh.h)."""

    primitive: Optional[str] = None     # quad|box|sphere|capsule|...
    params: Dict[str, Any] = field(default_factory=dict)
    asset: Optional[str] = None         # path for loaded meshes
    material: int = 0


@component("material")
class Material:
    """reference: pbr_material (src/rendering/pbr_material.h:25-60)."""

    albedo: Tuple[float, float, float] = (0.8, 0.8, 0.8)
    emissive: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    roughness: float = 0.5
    metallic: float = 0.0


@component("point_light")
class PointLight:
    """reference: point_light_component (src/rendering/light_source.h)."""

    color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    intensity: float = 1.0
    radius: float = 10.0
    casts_shadow: bool = False


@component("spot_light")
class SpotLight:
    color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    intensity: float = 1.0
    distance: float = 25.0
    inner_angle: float = 0.3
    outer_angle: float = 0.5
    direction: Tuple[float, float, float] = (0.0, -1.0, 0.0)
    casts_shadow: bool = False


@component("directional_light")
class DirectionalLight:
    """The sun (reference: directional_light, src/rendering/light_source.h)."""

    direction: Tuple[float, float, float] = (-0.6, -0.8, -0.3)
    color: Tuple[float, float, float] = (1.0, 0.93, 0.84)
    intensity: float = 50.0
    num_cascades: int = 3
    casts_shadow: bool = True


@component("joint")
class Joint:
    """Constraint to another entity's rigid body (reference: constraint
    entity handles + per-type constraint structs, src/physics/constraints.h
    and physics.cpp:147-330 addXxxConstraintFromGlobalPoints).  Anchors and
    axes are GLOBAL (authoring frame); compile_physics localizes them.
    Entities may hold several joints (stored as a list, like colliders).

    Motor conventions follow the solver (physics/joints.py): motor_type
    "velocity" drives toward `motor_target` rad/s (or m/s for sliders),
    "position" toward a target angle/offset; `motor_max` is the max
    torque/force, <= 0 disables the motor."""

    kind: str = "hinge"        # distance|ball|fixed|hinge|cone_twist|slider
    other: int = -1            # entity id of body B
    anchor: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    anchor_b: Optional[Tuple[float, float, float]] = None  # distance only
    axis: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    length: Optional[float] = None        # distance rest length
    limit_min: Optional[float] = None     # hinge angle / slider neg offset
    limit_max: Optional[float] = None
    swing_limit: float = -1.0             # cone-twist (negative = disabled)
    twist_limit: float = -1.0
    motor_type: str = "velocity"          # velocity | position
    motor_target: float = 0.0
    motor_max: float = 0.0                # max torque/force; <= 0 disables
    collide_connected: bool = False


@component("cloth")
class Cloth:
    """reference: cloth_component (src/physics/cloth.h:5-56)."""

    width: float = 1.0
    height: float = 1.0
    grid_x: int = 16
    grid_y: int = 16
    total_mass: float = 1.0
    stiffness: float = 0.5
    damping: float = 0.3
    gravity_factor: float = 1.0
    fix_top_row: bool = True


@component("terrain")
class Terrain:
    """reference: terrain_component (src/terrain/terrain.h:31)."""

    chunks_x: int = 4
    chunks_z: int = 4
    chunk_size: float = 64.0
    amplitude_scale: float = 30.0
    seed: int = 1


@component("water")
class Water:
    """reference: water_component (src/terrain/water.h:16)."""

    extents: Tuple[float, float] = (10.0, 10.0)
    height: float = 0.0
    deep_color: Tuple[float, float, float, float] = (0.09, 0.27, 0.32, 0.89)
    shallow_color: Tuple[float, float, float, float] = (0.3, 0.73, 0.63, 0.42)


@component("raytrace")
class Raytrace:
    """Marker: include this entity's mesh in the BVH/TLAS
    (reference: raytrace_component)."""

    include: bool = True


@component("animation")
class Animation:
    """reference: animation_component (src/animation/animation.h)."""

    clip: int = 0
    time: float = 0.0
    speed: float = 1.0
