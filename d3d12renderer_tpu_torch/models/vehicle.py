"""Constraint vehicle (counterpart of ``d3d12renderer_tpu/models/vehicle.py``;
BASELINE config 4): motor, gear train, differential, steering rack and
suspension, 16 rigid parts driven entirely through joints and gear-tooth
contacts.

Power flows motor -> motor gear -> drive axis -> differential sun/spider ->
rear wheel gears purely through capsule-capsule tooth collision; the wheels
are cylinders, so their contacts with the teeth and the ground go through
GJK (physics/gjk.py) and the cylinder plane test.  Only the builder's
authoring API is called, so the JAX package's builder takes the same
vehicle.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np

from ..physics.builder import (
    SceneBuilder, _quat_from_to_np, _quat_mul_np, _quat_to_mat,
)

DENSITY = 2000.0
ROD_THICKNESS = 0.05

PART_NAMES = [
    "motor", "motor_gear", "drive_axis", "front_axis", "steering_wheel",
    "steering_axis", "left_wheel_suspension", "right_wheel_suspension",
    "left_front_wheel", "right_front_wheel", "left_wheel_arm",
    "right_wheel_arm", "differential_sun_gear", "differential_spider_gear",
    "left_rear_wheel", "right_rear_wheel",
]


def _deg(d):
    return d * math.pi / 180.0


def _aa(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    s = math.sin(angle / 2)
    return np.array([axis[0] * s, axis[1] * s, axis[2] * s, math.cos(angle / 2)])


@dataclass
class GearDesc:
    height: float = 0.1
    cylinder_radius: float = 0.2
    num_teeth: int = 8
    tooth_length: float = 0.07
    tooth_width: float = 0.1
    friction: float = 0.0
    density: float = DENSITY


@dataclass
class WheelDesc:
    height: float = 0.3
    radius: float = 0.7
    friction: float = 1.0
    density: float = 50.0


@dataclass
class VehicleInfo:
    bodies: Dict[str, int]
    motor_hinge: int          # builder joint id: velocity motor (throttle)
    steering_hinge: int       # builder joint id: position motor (steering)
    hinge_row: Dict[str, int] # row index within the compiled hinge table


def _add_gear_teeth(b: SceneBuilder, body: int, desc: GearDesc, rod_offset: float):
    """Radial tooth capsules (reference: vehicle.cpp:87-109)."""
    for i in range(desc.num_teeth):
        angle = i * 2.0 * math.pi / desc.num_teeth
        rot = _quat_to_mat(_aa((0, 1, 0), angle))
        center = rot @ np.array([desc.cylinder_radius + desc.tooth_length * 0.5, 0, 0])
        center = center + np.array([0.0, rod_offset, 0.0])
        half = rot @ np.array([desc.tooth_length * 0.5, 0.0, 0.0])
        b.add_capsule_collider_from_points(
            body, center - half, center + half, desc.tooth_width * 0.5,
            density=desc.density, friction=desc.friction, restitution=0.2,
        )


def build_vehicle(b: SceneBuilder, position=(0.0, 0.0, 0.0),
                  initial_rotation: float = 0.0) -> VehicleInfo:
    origin = np.asarray(position, np.float64)
    wrot = _aa((0, 1, 0), initial_rotation)
    wmat = _quat_to_mat(wrot)

    def xp(p):
        return wmat @ np.asarray(p, np.float64) + origin

    def xd(d):
        return wmat @ np.asarray(d, np.float64)

    def add_body(pos, rot=None):
        rot = rot if rot is not None else np.array([0.0, 0.0, 0.0, 1.0])
        return b.add_body(
            position=xp(pos), rotation=_quat_mul_np(wrot, rot).astype(np.float32),
            linear_damping=0.4, angular_damping=0.4,
        )

    motor_gear_desc = GearDesc()
    steering_wheel_desc = GearDesc(cylinder_radius=0.4, num_teeth=0)
    wheel_desc = WheelDesc()

    bodies: Dict[str, int] = {}

    # Motor / chassis (reference: vehicle.cpp:314-318).
    motor = add_body((0, 0, 0))
    b.add_box_collider(motor, half_extents=(0.6, 0.1, 1.0), density=DENSITY,
                       friction=0.0, restitution=0.2)
    bodies["motor"] = motor

    motor_gear_y = 0.25
    gear_offset = 0.26

    # Motor gear, hinge about Y with velocity motor (reference: :364-369).
    motor_gear = add_body((0, motor_gear_y, 0))
    _add_gear_teeth(b, motor_gear, motor_gear_desc, 0.0)
    bodies["motor_gear"] = motor_gear
    motor_hinge = b.add_hinge_joint(
        motor, motor_gear, xp((0, motor_gear_y, 0)), xd((0, 1, 0)),
        motor_type=0.0, motor_target=0.0, max_torque=500.0,
    )

    # Drive axis: gear at each end, spins about Z (reference: :371-377).
    drive_axis_len = 4.5
    da_rot = _aa((-1, 0, 0), _deg(90))
    da_pos = np.array([0.0, motor_gear_y + gear_offset, gear_offset])
    drive_axis = add_body(da_pos, da_rot)
    _add_gear_teeth(b, drive_axis, motor_gear_desc, 0.0)
    _add_gear_teeth(b, drive_axis, motor_gear_desc,
                    -(drive_axis_len * 0.57 - 1.1))
    bodies["drive_axis"] = drive_axis
    b.add_hinge_joint(motor, drive_axis, xp(da_pos), xd((0, 0, 1)))

    # Front axis: rigid rod fixed to chassis (reference: :379-386).
    axis_len = 1.5
    susp_len = 0.4
    front_axis_z = -drive_axis_len * 0.5 + gear_offset * 2.0
    front_axis_pos = np.array([0.0, motor_gear_y + gear_offset, front_axis_z])
    front_axis = add_body(front_axis_pos)
    bodies["front_axis"] = front_axis
    b.add_fixed_joint(motor, front_axis, xp(front_axis_pos))

    # Steering wheel with gear attachment, position motor (reference: :388-399).
    sw_rot = _aa((-1, 0, 0), _deg(-80))
    sw_pos = np.array([0.0, 1.12, 0.81])
    steering_wheel = add_body(sw_pos, sw_rot)
    _add_gear_teeth(b, steering_wheel, motor_gear_desc, 2.0)
    bodies["steering_wheel"] = steering_wheel
    steering_hinge = b.add_hinge_joint(
        motor, steering_wheel, xp(sw_pos),
        xd(_quat_to_mat(sw_rot) @ np.array([0.0, -1.0, 0.0])),
        motor_type=1.0, motor_target=0.0, max_torque=1000.0,
    )

    # Steering rack: tooth capsules along a rod, slider in X (reference: :401-410).
    sa_pos = np.array([0.0, motor_gear_y + gear_offset + 0.06, front_axis_z + 0.49])
    sa_len = axis_len * 1.05
    steering_axis = add_body(sa_pos, sw_rot)
    # Rack teeth (reference: createGearAxis vehicle.cpp:169-215): capsules along
    # local X, teeth pointing +Y.
    tw = motor_gear_desc.tooth_width
    tl = motor_gear_desc.tooth_length
    stride = (sa_len - tw) / (motor_gear_desc.num_teeth - 1)
    left_off = -0.5 * sa_len + 0.5 * tw
    for i in range(motor_gear_desc.num_teeth):
        x = left_off + i * stride
        c = np.array([x, tw * 0.5, 0.0])
        h = np.array([0.0, tl * 0.5, 0.0])
        b.add_capsule_collider_from_points(
            steering_axis, c - h, c + h, tw * 0.5,
            density=DENSITY, friction=0.0, restitution=0.2,
        )
    bodies["steering_axis"] = steering_axis
    b.add_slider_joint(motor, steering_axis, xp(sa_pos), xd((1, 0, 0)),
                       neg_limit=-4.0, pos_limit=4.0)

    left_rack_attach = sa_pos - np.array([sa_len * 0.5, 0, 0])
    right_rack_attach = sa_pos + np.array([sa_len * 0.5, 0, 0])

    # Wheel suspensions: colliderless bodies, hinge about Y +-45 deg
    # (reference: :412-423).
    l_susp_pos = front_axis_pos - np.array([axis_len, 0, 0])
    r_susp_pos = front_axis_pos + np.array([axis_len, 0, 0])
    l_susp_attach = l_susp_pos + np.array([0, 0, susp_len])
    r_susp_attach = r_susp_pos + np.array([0, 0, susp_len])
    l_susp = add_body(l_susp_pos)
    r_susp = add_body(r_susp_pos)
    bodies["left_wheel_suspension"] = l_susp
    bodies["right_wheel_suspension"] = r_susp
    b.add_hinge_joint(motor, l_susp, xp(l_susp_pos), xd((0, 1, 0)),
                      min_limit=_deg(-45), max_limit=_deg(45))
    b.add_hinge_joint(motor, r_susp, xp(r_susp_pos), xd((0, 1, 0)),
                      min_limit=_deg(-45), max_limit=_deg(45))

    # Front wheels: cylinders hinged to suspensions (reference: :426-437).
    wheel_rot_l = _aa((0, 0, 1), _deg(90))
    l_wheel_pos = l_susp_pos - np.array([susp_len * 0.5, 0, 0])
    r_wheel_pos = r_susp_pos + np.array([susp_len * 0.5, 0, 0])
    for name, pos in [("left_front_wheel", l_wheel_pos),
                      ("right_front_wheel", r_wheel_pos)]:
        w = add_body(pos, wheel_rot_l)
        b.add_cylinder_collider(w, radius=wheel_desc.radius,
                                half_length=wheel_desc.height * 0.5,
                                density=wheel_desc.density,
                                friction=wheel_desc.friction, restitution=0.2)
        bodies[name] = w
    b.add_hinge_joint(bodies["left_front_wheel"], l_susp, xp(l_wheel_pos), xd((1, 0, 0)))
    b.add_hinge_joint(bodies["right_front_wheel"], r_susp, xp(r_wheel_pos), xd((1, 0, 0)))

    # Steering arms: rods linking rack ends to suspension arms via ball joints
    # (reference: :440-447).
    def rod(name, p_from, p_to):
        mid = 0.5 * (np.asarray(p_from) + np.asarray(p_to))
        axis = np.asarray(p_to, np.float64) - p_from
        axis = axis / np.linalg.norm(axis)
        rot = _quat_from_to_np(np.array([0.0, 1.0, 0.0]), axis)
        body = add_body(mid, rot)
        bodies[name] = body
        return body

    l_arm = rod("left_wheel_arm", left_rack_attach, l_susp_attach)
    r_arm = rod("right_wheel_arm", right_rack_attach, r_susp_attach)
    b.add_ball_joint(l_susp, l_arm, xp(l_susp_attach))
    b.add_ball_joint(steering_axis, l_arm, xp(left_rack_attach))
    b.add_ball_joint(r_susp, r_arm, xp(r_susp_attach))
    b.add_ball_joint(steering_axis, r_arm, xp(right_rack_attach))

    # Differential (reference: :452-487).
    rear_gear_desc = GearDesc(cylinder_radius=0.5, num_teeth=17)
    rear_z = drive_axis_len * 0.505
    rear_x = -gear_offset
    sun_pos = np.array([rear_x, motor_gear_y + gear_offset, rear_z])
    sun = add_body(sun_pos, _aa((0, 0, -1), _deg(90)))
    _add_gear_teeth(b, sun, rear_gear_desc, 0.0)
    bodies["differential_sun_gear"] = sun
    b.add_hinge_joint(motor, sun, xp(sun_pos), xd((1, 0, 0)))

    spider_pos = np.array([0.11, motor_gear_y + gear_offset * 2.0, rear_z])
    spider = add_body(spider_pos)
    _add_gear_teeth(b, spider, motor_gear_desc, 0.0)
    bodies["differential_spider_gear"] = spider
    b.add_hinge_joint(sun, spider, xp(spider_pos), xd((0, 1, 0)))

    l_rear_pos = spider_pos + np.array([-gear_offset, -gear_offset, 0.0])
    r_rear_pos = spider_pos + np.array([gear_offset, -gear_offset, 0.0])
    rear_rot = _aa((0, 0, -1), _deg(90))
    for name, pos, wheel_off in [
        ("left_rear_wheel", l_rear_pos, axis_len + spider_pos[0]),
        ("right_rear_wheel", r_rear_pos, -(axis_len - spider_pos[0])),
    ]:
        w = add_body(pos, rear_rot)
        _add_gear_teeth(b, w, motor_gear_desc, 0.0)
        # Wheel cylinder attachment at the outboard end of the axle
        # (reference: attach() attachment_type_wheel vehicle.cpp:111-130).
        b.add_cylinder_collider(
            w, radius=wheel_desc.radius, half_length=wheel_desc.height * 0.5,
            center=(0.0, wheel_off, 0.0), density=wheel_desc.density,
            friction=wheel_desc.friction, restitution=0.2,
        )
        bodies[name] = w
        b.add_hinge_joint(motor, w, xp(pos), xd((1, 0, 0)))

    # Rows in the compiled hinge table follow hinge-joint insertion order.
    hinge_ids = [i for i, j in enumerate(b.joints) if j.kind == "hinge"]
    return VehicleInfo(
        bodies=bodies, motor_hinge=motor_hinge, steering_hinge=steering_hinge,
        hinge_row={
            "motor": hinge_ids.index(motor_hinge),
            "steering": hinge_ids.index(steering_hinge),
        },
    )


def drive_overrides(arch, info: VehicleInfo, throttle_velocity,
                    steering_angle, batch: int = 1):
    """Motor overrides for `physics_step`: throttle (the velocity motor of
    the motor-gear hinge) and steering (the position motor of the
    steering-wheel hinge), each one value or one per scene; every other
    hinge at its own target.  Returns the tuple `joints.prep_all` reads:
    None per joint table, the hinge table's {"motor_target": (batch, J)
    tensor}."""
    hinge_table_idx = next(
        k for k, t in enumerate(arch.joints) if t.kind == "hinge"
    )
    base = arch.joints[hinge_table_idx].params["motor_target"]
    base = base.expand(batch, -1).clone()
    base[:, info.hinge_row["motor"]] = base.new_tensor(throttle_velocity)
    base[:, info.hinge_row["steering"]] = base.new_tensor(steering_angle)
    overrides = [None] * len(arch.joints)
    overrides[hinge_table_idx] = {"motor_target": base}
    return tuple(overrides)
