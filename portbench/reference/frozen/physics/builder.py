"""Host-side scene construction (counterpart of
the JAX package's ``physics/builder.py``).

The authoring API and the compilation to structure-of-arrays tables run in
numpy, exactly as in the JAX builder; torch tensors are made at the end on
the requested device.  Trimmed to what the ragdoll on a plane needs: box
and capsule colliders on static planes, no collider pairs, hinge and
cone-twist joints.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .types import (
    MAX_HULL_VERTS,
    SHAPE_BOX,
    SHAPE_CAPSULE,
    SHAPE_CYLINDER,
    SHAPE_HULL,
    SHAPE_SPHERE,
    BodyState,
    ContactBucket,
    JointTable,
    SceneArchetype,
)

_IDENTITY_QUAT = np.array([0.0, 0.0, 0.0, 1.0], np.float32)
JOINT_KINDS = ("distance", "ball", "fixed", "hinge", "cone_twist", "slider")


@dataclass
class _Collider:
    body: int
    shape: int
    local_pos: np.ndarray
    local_rot: np.ndarray
    size: np.ndarray
    density: float
    friction: float
    restitution: float
    hull_verts: Optional[np.ndarray] = None  # (V, 3), collider frame


@dataclass
class _Body:
    pos: np.ndarray
    rot: np.ndarray
    kinematic: bool
    mass_override: Optional[float]
    gravity_factor: float
    linear_damping: float
    angular_damping: float
    colliders: List[int] = field(default_factory=list)
    no_collide_group: int = -1


@dataclass
class _Joint:
    kind: str
    body_a: int
    body_b: int
    params: Dict[str, np.ndarray]
    collide_connected: bool = False


def _shape_mass_properties(c: _Collider):
    """(mass, inertia about the shape COG: its diagonal, or the 3x3 matrix
    of a hull, shape COG)."""
    rho = c.density
    if c.shape == SHAPE_SPHERE:
        r = float(c.size[0])
        mass = rho * 4.0 / 3.0 * math.pi * r ** 3
        i = 2.0 / 5.0 * mass * r * r
        return mass, np.array([i, i, i]), np.zeros(3)
    if c.shape == SHAPE_BOX:
        hx, hy, hz = (float(s) for s in c.size)
        mass = rho * 8.0 * hx * hy * hz
        ix = mass / 3.0 * (hy * hy + hz * hz)
        iy = mass / 3.0 * (hx * hx + hz * hz)
        iz = mass / 3.0 * (hx * hx + hy * hy)
        return mass, np.array([ix, iy, iz]), np.zeros(3)
    if c.shape == SHAPE_CYLINDER:
        r, hh = float(c.size[0]), float(c.size[1])
        h = 2.0 * hh
        mass = rho * math.pi * r * r * h
        iy = 0.5 * mass * r * r
        ix = mass / 12.0 * (3 * r * r + h * h)
        return mass, np.array([ix, iy, ix]), np.zeros(3)
    if c.shape == SHAPE_CAPSULE:
        r, hh = float(c.size[0]), float(c.size[1])
        h = 2.0 * hh
        m_cyl = rho * math.pi * r * r * h
        m_hemi = rho * 2.0 / 3.0 * math.pi * r ** 3
        mass = m_cyl + 2 * m_hemi
        iy = 0.5 * m_cyl * r * r
        ix = m_cyl / 12.0 * (3 * r * r + h * h)
        i_hemi_y = 2.0 / 5.0 * m_hemi * r * r
        d = hh + 3.0 * r / 8.0
        i_hemi_x = 2.0 / 5.0 * m_hemi * r * r + m_hemi * d * d
        iy += 2 * i_hemi_y
        ix += 2 * i_hemi_x
        return mass, np.array([ix, iy, ix]), np.zeros(3)
    raise NotImplementedError(f"mass properties for shape {c.shape}")


def _quat_to_mat(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _quat_mul_np(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ])


def _quat_from_to_np(a, b):
    w = 1.0 + float(a @ b)
    if w < 1e-6:
        t1, _ = _orthonormal_basis_np(a)
        q = np.array([t1[0], t1[1], t1[2], 0.0])
    else:
        v = np.cross(a, b)
        q = np.array([v[0], v[1], v[2], w])
    return q / np.linalg.norm(q)


def _orthonormal_basis_np(n):
    sign = 1.0 if n[2] >= 0.0 else -1.0
    a = -1.0 / (sign + n[2])
    b = n[0] * n[1] * a
    t1 = np.array([1.0 + sign * n[0] * n[0] * a, sign * b, -sign * n[0]])
    t2 = np.array([b, sign + n[1] * n[1] * a, -n[1]])
    return t1, t2


def _greedy_color(rows: Sequence[Tuple[int, int]], static_body: int) -> List[int]:
    """Rows sharing a dynamic body get distinct colors (first fit)."""
    used_per_color: List[set] = []
    colors: List[int] = []
    for (a, b) in rows:
        keys = [x for x in (a, b) if x != static_body]
        col = 0
        while True:
            if col == len(used_per_color):
                used_per_color.append(set())
            if all(k not in used_per_color[col] for k in keys):
                used_per_color[col].update(keys)
                colors.append(col)
                break
            col += 1
    return colors


def _color_index_lists(colors: Sequence[int]) -> List[np.ndarray]:
    num_colors = (max(colors) + 1) if colors else 0
    c = np.array(colors)
    return [np.nonzero(c == col)[0].astype(np.int64)
            for col in range(num_colors)]


def _build_joint_tables(joints: List[_Joint], num_bodies: int, device):
    """Group joints by kind (sorted), color each kind on its own."""
    by_kind: Dict[str, List[_Joint]] = {}
    for j in joints:
        by_kind.setdefault(j.kind, []).append(j)

    def t(x, dtype=torch.int64):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    tables, color_indices_all = [], []
    for kind in sorted(by_kind.keys()):
        js = by_kind[kind]
        rows = [(j.body_a if j.body_a >= 0 else num_bodies,
                 j.body_b if j.body_b >= 0 else num_bodies) for j in js]
        colors = _greedy_color(rows, static_body=num_bodies)
        idx = _color_index_lists(colors)
        params = {key: t(np.stack([j.params[key] for j in js]), torch.float32)
                  for key in js[0].params}
        tables.append(JointTable(
            body_a=t([r[0] for r in rows]), body_b=t([r[1] for r in rows]),
            color=t(colors), valid=t(np.ones(len(js), bool), torch.bool),
            params=params, kind=kind, num_colors=len(idx)))
        color_indices_all.append(tuple(t(i) for i in idx))
    return tuple(tables), tuple(color_indices_all)


class SceneBuilder:
    """Authoring API:

        b = SceneBuilder()
        b.add_static_plane((0, 1, 0), 0.0)
        body = b.add_body(position=(0, 5, 0))
        b.add_box_collider(body, half_extents=(0.5, 0.5, 0.5))
        arch, state0 = b.finalize(device="cuda")
    """

    def __init__(self):
        self.bodies: List[_Body] = []
        self.colliders: List[_Collider] = []
        self.planes: List[Tuple[np.ndarray, float, float, float]] = []
        self.terrains: List[Tuple[np.ndarray, np.ndarray, float, float,
                                  float]] = []
        self.force_fields: List[Tuple[np.ndarray, float, np.ndarray]] = []
        self.triggers: List[Tuple[np.ndarray, float]] = []
        self.joints: List[_Joint] = []
        self._no_collide_groups = 0

    # -- bodies ------------------------------------------------------------

    def add_body(self, position=(0.0, 0.0, 0.0), rotation=None, kinematic=False,
                 mass=None, gravity_factor=1.0, linear_damping=0.4,
                 angular_damping=0.4) -> int:
        rot = (np.asarray(rotation, np.float32) if rotation is not None
               else _IDENTITY_QUAT.copy())
        self.bodies.append(_Body(
            pos=np.asarray(position, np.float32), rot=rot, kinematic=kinematic,
            mass_override=mass, gravity_factor=gravity_factor,
            linear_damping=linear_damping, angular_damping=angular_damping))
        return len(self.bodies) - 1

    def new_no_collide_group(self) -> int:
        self._no_collide_groups += 1
        return self._no_collide_groups - 1

    def set_no_collide_group(self, body: int, group: int):
        self.bodies[body].no_collide_group = group

    # -- colliders ---------------------------------------------------------

    def _add_collider(self, body, shape, local_pos, local_rot, size,
                      density, friction, restitution) -> int:
        self.colliders.append(_Collider(
            body=body, shape=shape,
            local_pos=np.asarray(local_pos, np.float32),
            local_rot=np.asarray(local_rot, np.float32),
            size=np.asarray(size, np.float32),
            density=density, friction=friction, restitution=restitution))
        if body >= 0:
            self.bodies[body].colliders.append(len(self.colliders) - 1)
        return len(self.colliders) - 1

    def add_box_collider(self, body, half_extents, center=(0, 0, 0),
                         rotation=None, density=1000.0, friction=0.5,
                         restitution=0.0):
        rot = (np.asarray(rotation, np.float32) if rotation is not None
               else _IDENTITY_QUAT)
        return self._add_collider(body, SHAPE_BOX, center, rot, half_extents,
                                  density, friction, restitution)

    def add_capsule_collider_from_points(self, body, point_a, point_b, radius,
                                         density=1000.0, friction=0.5,
                                         restitution=0.0):
        """Capsule given by its two hemisphere centres in the body frame."""
        a = np.asarray(point_a, np.float64)
        c = np.asarray(point_b, np.float64)
        center = 0.5 * (a + c)
        d = c - a
        l = np.linalg.norm(d)
        if l < 1e-9:
            rot, half = _IDENTITY_QUAT, 0.0
        else:
            rot = _quat_from_to_np(np.array([0.0, 1.0, 0.0]), d / l)
            half = 0.5 * l
        return self._add_collider(body, SHAPE_CAPSULE, center,
                                  rot.astype(np.float32), (radius, half, 0),
                                  density, friction, restitution)

    def add_static_plane(self, normal, offset, friction=0.8, restitution=0.0):
        n = np.asarray(normal, np.float64)
        n = n / np.linalg.norm(n)
        self.planes.append((n.astype(np.float32), float(offset), friction,
                            restitution))
        return len(self.planes) - 1

    # -- joints ------------------------------------------------------------

    def add_joint(self, kind: str, body_a: int, body_b: int,
                  collide_connected: bool = False, **params):
        if kind not in JOINT_KINDS:
            raise ValueError(f"unknown joint kind {kind!r}; the kinds are "
                             f"{JOINT_KINDS}")
        self.joints.append(_Joint(
            kind=kind, body_a=body_a, body_b=body_b,
            params={k: np.asarray(v, np.float32) for k, v in params.items()},
            collide_connected=collide_connected))
        return len(self.joints) - 1

    def _body_pose(self, body: int):
        if body < 0:
            return np.zeros(3), _IDENTITY_QUAT.copy()
        b = self.bodies[body]
        return b.pos.astype(np.float64), b.rot.astype(np.float64)

    def _to_local_point(self, body: int, p):
        pos, rot = self._body_pose(body)
        return _quat_to_mat(rot).T @ (np.asarray(p, np.float64) - pos)

    def _to_local_dir(self, body: int, d):
        _, rot = self._body_pose(body)
        return _quat_to_mat(rot).T @ np.asarray(d, np.float64)

    def _axis_frames(self, body_a, body_b, global_axis):
        axis_a = self._to_local_dir(body_a, global_axis)
        axis_a /= np.linalg.norm(axis_a)
        axis_b = self._to_local_dir(body_b, global_axis)
        axis_b /= np.linalg.norm(axis_b)
        tangent_a, bitangent_a = _orthonormal_basis_np(axis_a)
        _, qa = self._body_pose(body_a)
        tangent_b = self._to_local_dir(body_b, _quat_to_mat(qa) @ tangent_a)
        return dict(axis_a=axis_a, axis_b=axis_b, tangent_a=tangent_a,
                    bitangent_a=bitangent_a, tangent_b=tangent_b)

    def add_hinge_joint(self, body_a, body_b, global_anchor, global_axis,
                        min_limit=None, max_limit=None,
                        motor_type=0.0, motor_target=0.0, max_torque=None):
        """min_limit in [-pi, 0] / max_limit in [0, pi]; None disables.
        Motors run only with max_torque > 0; motor_type 0 = velocity,
        1 = position."""
        return self.add_joint(
            "hinge", body_a, body_b,
            anchor_a=self._to_local_point(body_a, global_anchor),
            anchor_b=self._to_local_point(body_b, global_anchor),
            **self._axis_frames(body_a, body_b, global_axis),
            min_limit=(min_limit if min_limit is not None else 1.0),
            max_limit=(max_limit if max_limit is not None else -1.0),
            motor_type=motor_type, motor_target=motor_target,
            max_torque=(max_torque if max_torque is not None else -1.0),
        )

    def add_cone_twist_joint(self, body_a, body_b, global_anchor, global_axis,
                             swing_limit=-1.0, twist_limit=-1.0,
                             swing_motor_type=0.0, swing_target=0.0,
                             swing_axis_angle=0.0, max_swing_torque=None,
                             twist_motor_type=0.0, twist_target=0.0,
                             max_twist_torque=None):
        """Negative swing/twist limits disable them."""
        return self.add_joint(
            "cone_twist", body_a, body_b,
            anchor_a=self._to_local_point(body_a, global_anchor),
            anchor_b=self._to_local_point(body_b, global_anchor),
            **self._axis_frames(body_a, body_b, global_axis),
            swing_limit=swing_limit, twist_limit=twist_limit,
            swing_motor_type=swing_motor_type, swing_target=swing_target,
            swing_axis_angle=swing_axis_angle,
            max_swing_torque=(max_swing_torque
                              if max_swing_torque is not None else -1.0),
            twist_motor_type=twist_motor_type, twist_target=twist_target,
            max_twist_torque=(max_twist_torque
                              if max_twist_torque is not None else -1.0),
        )

    # -- compilation -------------------------------------------------------

    def _mass_properties(self):
        """Aggregate collider masses into per-body mass, COG and inertia."""
        n = len(self.bodies)
        inv_mass = np.zeros(n + 1, np.float32)
        inv_inertia = np.zeros((n + 1, 3, 3), np.float32)
        local_cog = np.zeros((n + 1, 3), np.float32)
        for bi, b in enumerate(self.bodies):
            if b.kinematic:
                continue
            total_mass = 0.0
            cog = np.zeros(3)
            items = []
            for ci in b.colliders:
                c = self.colliders[ci]
                mass, ishape, shape_cog = _shape_mass_properties(c)
                rot = _quat_to_mat(c.local_rot.astype(np.float64))
                com = c.local_pos.astype(np.float64) + rot @ shape_cog
                items.append((mass, ishape, rot, com))
                total_mass += mass
                cog += mass * com
            if total_mass <= 0.0:
                inv_mass[bi] = 1.0
                inv_inertia[bi] = np.eye(3)
                continue
            cog /= total_mass
            inertia = np.zeros((3, 3))
            for mass, ishape, rot, com in items:
                imat = np.diag(ishape) if np.ndim(ishape) == 1 else ishape
                i_local = rot @ imat @ rot.T
                d = com - cog
                i_local += mass * ((d @ d) * np.eye(3) - np.outer(d, d))
                inertia += i_local
            if b.mass_override is not None:
                scale = b.mass_override / total_mass
                total_mass *= scale
                inertia *= scale
            inv_mass[bi] = 1.0 / total_mass
            inv_inertia[bi] = np.linalg.inv(inertia)
            local_cog[bi] = cog
        return inv_mass, inv_inertia, local_cog

    def _collides(self, body_a: int, body_b: int) -> bool:
        if body_a == body_b:
            return False
        ba, bb = self.bodies[body_a], self.bodies[body_b]
        if ba.kinematic and bb.kinematic:
            return False
        if ba.no_collide_group >= 0 and ba.no_collide_group == bb.no_collide_group:
            return False
        for j in self.joints:
            if {j.body_a, j.body_b} == {body_a, body_b} and not j.collide_connected:
                return False
        return True

    def _pair_rows(self):
        """The frozen reference collides no collider pairs: every pair has
        to be filtered out, as the ragdoll's are."""
        c = len(self.colliders)
        for i in range(c):
            for j in range(i + 1, c):
                if self._collides(self.colliders[i].body,
                                  self.colliders[j].body):
                    raise NotImplementedError(
                        "the frozen reference has no collider pairs")
        return {}

    def finalize(self, dtype=np.float32, device="cuda"):
        """Compile into (SceneArchetype, BodyState) on `device`; the state
        has a leading batch axis of 1."""
        device = resolve_device(device)

        n = len(self.bodies)
        c = len(self.colliders)
        g = len(self.planes)
        inv_mass, inv_inertia, local_cog = self._mass_properties()

        bound_radius = np.zeros(c, np.float32)
        for i, cl in enumerate(self.colliders):
            if cl.shape == SHAPE_SPHERE:
                r = cl.size[0]
            elif cl.shape in (SHAPE_CAPSULE, SHAPE_CYLINDER):
                r = cl.size[0] + cl.size[1]
            elif cl.shape == SHAPE_HULL:
                r = float(np.linalg.norm(cl.hull_verts, axis=-1).max())
            else:
                r = float(np.linalg.norm(cl.size))
            bound_radius[i] = r + np.linalg.norm(cl.local_pos)

        hull_verts = np.zeros((c, MAX_HULL_VERTS, 3), np.float32)
        hull_mask = np.zeros((c, MAX_HULL_VERTS), bool)
        for i, cl in enumerate(self.colliders):
            if cl.hull_verts is not None:
                hull_verts[i, :len(cl.hull_verts)] = cl.hull_verts
                hull_mask[i, :len(cl.hull_verts)] = True

        # Plane and terrain rows: every dynamic collider against each,
        # sorted by collider shape into one segment per type.
        def static_rows(count):
            rows = [(ci, k, cl.body) for ci, cl in enumerate(self.colliders)
                    if cl.body >= 0 and not self.bodies[cl.body].kinematic
                    for k in range(count)]
            rows.sort(key=lambda r: self.colliders[r[0]].shape)
            segs = []
            for (ci, _, _) in rows:
                st = self.colliders[ci].shape
                if segs and segs[-1][0] == st:
                    segs[-1] = (st, segs[-1][1], segs[-1][2] + 1)
                else:
                    start = segs[-1][2] if segs else 0
                    segs.append((st, start, start + 1))
            return rows, tuple(segs)

        vs_plane_rows, segs = static_rows(g)
        t_count = len(self.terrains)
        vs_terrain_rows, terrain_segs = static_rows(t_count)

        pair_rows = self._pair_rows()
        sap_tables = dict(
            sap_collidable=np.zeros((0, 0), bool), sap_type_pairs=(),
            sap_body_kinematic=np.zeros(0, bool),
            sap_body_group=np.zeros(0, np.int64),
            sap_joint_excl=np.zeros((0, 2), np.int64))
        bucket_keys = sorted(pair_rows)

        # One greedy coloring over the whole contact table: plane rows,
        # terrain rows, then the buckets in order, as generate_contacts
        # concatenates them.
        all_rows = [(n, r[2]) for r in vs_plane_rows + vs_terrain_rows]
        for key in bucket_keys:
            all_rows += [(r[2], r[3]) for r in pair_rows[key]]
        colors = _greedy_color(all_rows, static_body=n)
        contact_idx = _color_index_lists(colors)
        q = len(vs_plane_rows)

        joint_tables, joint_color_indices = _build_joint_tables(
            self.joints, n, device)

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        def i64(x):
            return torch.as_tensor(np.asarray(x, np.int64).reshape(-1),
                                   device=device)

        def stack(rows, width):
            return np.stack(rows) if rows else np.zeros((0, width), np.float32)

        q2 = len(vs_terrain_rows)
        buckets, offset = [], q + q2
        for key in bucket_keys:
            rows = pair_rows[key]
            k = len(rows)
            buckets.append(ContactBucket(
                collider_a=i64([r[0] for r in rows]),
                collider_b=i64([r[1] for r in rows]),
                body_a=i64([r[2] for r in rows]),
                body_b=i64([r[3] for r in rows]),
                color=i64(colors[offset:offset + k]),
                valid=torch.ones(k, dtype=torch.bool, device=device),
                type_a=key[0], type_b=key[1], num_colors=len(contact_idx)))
            offset += k

        arch = SceneArchetype(
            inv_mass=f32(inv_mass),
            inv_inertia=f32(inv_inertia),
            gravity_factor=f32(np.append(
                [b.gravity_factor for b in self.bodies], 0.0)),
            linear_damping=f32(np.append(
                [b.linear_damping for b in self.bodies], 0.0)),
            angular_damping=f32(np.append(
                [b.angular_damping for b in self.bodies], 0.0)),
            local_cog=f32(local_cog),
            col_body=i64([cl.body for cl in self.colliders]),
            col_type=i64([cl.shape for cl in self.colliders]),
            col_local_pos=f32(stack([cl.local_pos for cl in self.colliders], 3)),
            col_local_rot=f32(stack([cl.local_rot for cl in self.colliders], 4)),
            col_size=f32(stack([cl.size for cl in self.colliders], 3)),
            col_friction=f32([cl.friction for cl in self.colliders]),
            col_restitution=f32([cl.restitution for cl in self.colliders]),
            col_bound_radius=f32(bound_radius),
            col_hull_verts=f32(hull_verts),
            col_hull_mask=torch.as_tensor(hull_mask, device=device),
            plane_normal=f32(stack([p[0] for p in self.planes], 3)),
            plane_offset=f32([p[1] for p in self.planes]),
            plane_friction=f32([p[2] for p in self.planes]),
            plane_restitution=f32([p[3] for p in self.planes]),
            vs_plane_collider=i64([r[0] for r in vs_plane_rows]),
            vs_plane_plane=i64([r[1] for r in vs_plane_rows]),
            vs_plane_body=i64([r[2] for r in vs_plane_rows]),
            vs_plane_color=i64(colors[:q]),
            vs_plane_valid=torch.ones(q, dtype=torch.bool, device=device),
            terrain_height=f32(np.stack([t[0] for t in self.terrains])
                               if t_count else np.zeros((0, 1, 1))),
            terrain_origin=f32(stack([t[1] for t in self.terrains], 3)),
            terrain_cell=f32([t[2] for t in self.terrains]),
            terrain_friction=f32([t[3] for t in self.terrains]),
            terrain_restitution=f32([t[4] for t in self.terrains]),
            vs_terrain_collider=i64([r[0] for r in vs_terrain_rows]),
            vs_terrain_terrain=i64([r[1] for r in vs_terrain_rows]),
            vs_terrain_body=i64([r[2] for r in vs_terrain_rows]),
            vs_terrain_valid=torch.ones(q2, dtype=torch.bool, device=device),
            ff_center=f32(stack([f[0] for f in self.force_fields], 3)),
            ff_radius=f32([f[1] for f in self.force_fields]),
            ff_force=f32(stack([f[2] for f in self.force_fields], 3)),
            trigger_center=f32(stack([t[0] for t in self.triggers], 3)),
            trigger_radius=f32([t[1] for t in self.triggers]),
            contact_buckets=tuple(buckets),
            joints=joint_tables,
            contact_color_indices=tuple(i64(i) for i in contact_idx),
            joint_color_indices=joint_color_indices,
            num_bodies=n,
            num_colliders=c,
            num_planes=g,
            num_terrains=t_count,
            vs_plane_num_colors=len(contact_idx),
            vs_plane_segments=segs,
            vs_terrain_segments=terrain_segs,
            terrain_tri_exact=False,
            sap_neighbors=0,
            sap_max_contacts=0,
            sap_row_cap=16,
            sap_mode="sweep",
            sap_active_budget=0,
            sap_type_pairs=sap_tables["sap_type_pairs"],
            sap_collidable=torch.as_tensor(sap_tables["sap_collidable"],
                                           device=device),
            sap_body_kinematic=torch.as_tensor(
                sap_tables["sap_body_kinematic"], device=device),
            sap_body_group=i64(sap_tables["sap_body_group"]),
            sap_joint_excl=torch.as_tensor(sap_tables["sap_joint_excl"],
                                           device=device),
        )
        if arch.terrain_tri_exact and t_count:
            # The mips depend on the heights alone: built once, here.
            from .heightmap_collision import terrain_mips
            terrain_mips(arch)

        # Float32 like the JAX builder: pos + R @ local_cog.
        rot = np.stack([b.rot for b in self.bodies]).astype(dtype)
        rmat = np.stack([_quat_to_mat(b.rot.astype(np.float64))
                         for b in self.bodies]).astype(dtype)
        pos = (np.stack([b.pos for b in self.bodies]).astype(dtype)
               + np.einsum("nij,nj->ni", rmat, local_cog[:n].astype(dtype)))
        z3 = torch.zeros((1, n, 3), dtype=torch.float32, device=device)
        state = BodyState(
            pos=f32(pos)[None], rot=f32(rot)[None], vel=z3, omega=z3.clone(),
            force=z3.clone(), torque=z3.clone())
        return arch, state
