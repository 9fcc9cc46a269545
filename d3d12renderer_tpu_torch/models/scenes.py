"""Small physics scenes written against the scene builder's authoring API.

Each function takes a builder, adds its scene and returns the new bodies by
name; the caller finalizes.  Only the builder's methods are called, so the
JAX package's `SceneBuilder` takes the same scenes (the tests build both and
compare the archetypes).

* `add_chain`: a kinematic anchor and four bodies (sphere, box, sphere, box)
  on the ground plane, jointed distance -> ball -> fixed -> hinge, all in
  one no-collide group (plane contacts only).
* `add_slider_zoo`: the chain, a motored and limited slider, and a cluster
  of free spheres, capsules and boxes placed so that every pair function of
  `physics/narrow.py` has touching rows (the constraint zoo of BASELINE
  config 2, cut to one of each joint kind).
* `add_stack_drop`: three boxes stacked on the plane and a sphere dropped
  beside them (`examples/stack_drop.py`).
* `add_stack_drop_1k`: BASELINE config 1, a jittered grid of boxes and
  spheres dropped onto the plane (`examples/stack_drop_1k.py`); finalize it
  with `STACK_DROP_1K_FINALIZE`, the runtime broadphase's settings.
* `add_terrain_drop`: `examples/showcase.py`'s physics, boxes and spheres
  dropped onto its 65 x 65 heightmap (`terrain_drop_heights`).
* `add_ridge`: a wide flat box dropped on the crest of a 9 x 9 ridge
  (`tests/test_heightmap_mip.py`), finalized with
  `terrain_collision="triangles"`.
* `add_cloth_colliders`: the rigid side of the coupled cloth step
  (`tests/test_cloth.py`): a sphere that rolls under the cloth and a
  capsule held in place, with `CLOTH_*` the cloth's settings.
* `add_terrain` of a vehicle: `vehicle_terrain_heights` is
  `examples/vehicle_terrain.py`'s heightmap, `VEHICLE_TERRAIN` its placement.
* `add_flythrough_pile`: `examples/flythrough.py`'s pile, 18 boxes and
  spheres stacked in a loose column over the plane (numpy seed 4).
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Capsules lie along their local y axis; these turn it onto x and z.
_Y_TO_X = (0.0, 0.0, -math.sqrt(0.5), math.sqrt(0.5))
_Y_TO_Z = (math.sqrt(0.5), 0.0, 0.0, math.sqrt(0.5))

# The zoo's slider: travel along x, limits and motor.
SLIDER_AXIS = (1.0, 0.0, 0.0)
SLIDER_LIMITS = (-0.3, 0.3)
SLIDER_MOTOR_SPEED = 0.5
SLIDER_MAX_FORCE = 20.0


def add_chain(b):
    """The jointed chain; plane at y = 0 included."""
    b.add_static_plane((0.0, 1.0, 0.0), 0.0, friction=0.9, restitution=0.2)
    group = b.new_no_collide_group()
    anchor = b.add_body((0.0, 1.2, 0.0), kinematic=True)
    b.set_no_collide_group(anchor, group)
    bodies = []
    for i in range(4):
        body = b.add_body((0.5 * (i + 1), 0.45 if i % 2 == 0 else 0.28, 0.0))
        if i % 2 == 0:
            b.add_sphere_collider(body, radius=0.5, friction=0.7)
        else:
            b.add_box_collider(body, (0.3, 0.3, 0.2), restitution=0.3)
        b.set_no_collide_group(body, group)
        bodies.append(body)
    b.add_distance_joint(anchor, bodies[0], (0.0, 1.2, 0.0), (0.5, 0.45, 0.0))
    b.add_ball_joint(bodies[0], bodies[1], (0.75, 0.4, 0.0))
    b.add_fixed_joint(bodies[1], bodies[2], (1.25, 0.35, 0.0))
    b.add_hinge_joint(bodies[2], bodies[3], (1.75, 0.35, 0.0),
                      (0.0, 0.0, 1.0), min_limit=-0.5, max_limit=0.5,
                      motor_type=1.0, motor_target=0.3, max_torque=50.0)
    return {"anchor": anchor, "chain": bodies}


def add_slider_zoo(b):
    """The chain, a slider and a touching cluster of free colliders."""
    out = add_chain(b)

    # Slider: a carriage on a base resting on the ground, driven toward
    # its upper limit by a velocity motor.
    base = b.add_body((0.0, 0.1, -1.5))
    b.add_box_collider(base, (0.3, 0.1, 0.1))
    carriage = b.add_body((0.0, 0.35, -1.5))
    b.add_sphere_collider(carriage, radius=0.1)
    b.add_slider_joint(base, carriage, (0.0, 0.35, -1.5), SLIDER_AXIS,
                       neg_limit=SLIDER_LIMITS[0], pos_limit=SLIDER_LIMITS[1],
                       motor_type=0.0, motor_target=SLIDER_MOTOR_SPEED,
                       max_force=SLIDER_MAX_FORCE)
    out.update(base=base, carriage=carriage)

    def free(position, add):
        body = b.add_body(position)
        add(body)
        return body

    # Around a ground box: a box on top (box-box), a capsule against its +z
    # face (capsule-box) crossed by a second capsule at its end
    # (capsule-capsule, capsule-box), a sphere against its -x face
    # (sphere-box) beside another sphere (sphere-sphere), and a sphere on
    # the first capsule (sphere-capsule).
    out["cluster"] = [
        free((0.0, 0.2, 1.5), lambda body: b.add_box_collider(
            body, (0.4, 0.2, 0.4))),
        free((0.05, 0.6, 1.45), lambda body: b.add_box_collider(
            body, (0.2, 0.2, 0.2))),
        free((0.0, 0.1, 2.0), lambda body: b.add_capsule_collider(
            body, 0.1, 0.3, rotation=_Y_TO_X)),
        free((0.5, 0.1, 2.05), lambda body: b.add_capsule_collider(
            body, 0.1, 0.3, rotation=_Y_TO_Z)),
        free((-0.55, 0.15, 1.5), lambda body: b.add_sphere_collider(
            body, 0.15)),
        free((-0.55, 0.15, 1.8), lambda body: b.add_sphere_collider(
            body, 0.15)),
        free((0.0, 0.35, 2.0), lambda body: b.add_sphere_collider(
            body, 0.15)),
    ]
    return out


def add_stack_drop(b):
    """examples/stack_drop.py's scene: boxes settle at ~0.5 / 1.5 / 2.5,
    the sphere at ~0.4."""
    b.add_static_plane((0, 1, 0), 0.0, friction=0.8)
    boxes = []
    for i in range(3):
        body = b.add_body(position=(0, 0.5 + 1.05 * i, 0))
        b.add_box_collider(body, (0.5, 0.5, 0.5))
        boxes.append(body)
    sphere = b.add_body(position=(2.0, 3.0, 0))
    b.add_sphere_collider(sphere, radius=0.4, restitution=0.5)
    return {"boxes": boxes, "sphere": sphere}


# examples/stack_drop_1k.py's broadphase: the sweep window of 160 covers the
# widest same-axis slab of the 10x10x10 grid (overflow 0), 16 partners per
# collider, 4096 candidate rows and 3072 active rows.
STACK_DROP_1K_FINALIZE = dict(broadphase="sap", sap_neighbors=160,
                              sap_max_contacts=4096, sap_active_budget=3072)


def add_stack_drop_1k(b, num_bodies: int = 1000, seed: int = 0):
    """examples/stack_drop_1k.py's scene: `num_bodies` unit boxes and
    spheres (radius 0.5, mass 1), alternating in a checkerboard, on a cubic
    grid of pitch 1.15 jittered by +-0.05 (numpy seed `seed`) above the
    plane."""
    rng = np.random.default_rng(seed)
    b.add_static_plane((0.0, 1.0, 0.0), 0.0, friction=0.6, restitution=0.0)
    side = int(round(num_bodies ** (1.0 / 3.0)))
    while side * side * side < num_bodies:
        side += 1
    spacing = 1.15
    bodies = []
    for ix in range(side):
        for iy in range(side):
            for iz in range(side):
                if len(bodies) >= num_bodies:
                    break
                jitter = rng.uniform(-0.05, 0.05, 3)
                body = b.add_body(position=(
                    (ix - side / 2) * spacing + jitter[0],
                    1.0 + iy * spacing + jitter[1],
                    (iz - side / 2) * spacing + jitter[2]), mass=1.0)
                if (ix + iy + iz) % 2 == 0:
                    b.add_box_collider(body, (0.5, 0.5, 0.5), friction=0.6,
                                       restitution=0.1)
                else:
                    b.add_sphere_collider(body, 0.5, friction=0.6,
                                          restitution=0.1)
                bodies.append(body)
    return {"bodies": bodies}


# examples/showcase.py:86-90: the heightmap and its placement.
TERRAIN_DROP_MAP = dict(resolution=65, world_size=48.0, amplitude=5.0,
                        noise_scale=0.06, seed=7)
TERRAIN_DROP_ORIGIN = (-24.0, 0.0, -24.0)
TERRAIN_DROP_CELL = 48.0 / 64
TERRAIN_DROP_BODIES = 6
TERRAIN_DROP_HALF = 0.45     # the boxes' half extent and the spheres' radius


def terrain_drop_heights() -> np.ndarray:
    """The (65, 65) heightmap of examples/showcase.py."""
    from ..terrain.heightmap import generate_heightmap

    return generate_heightmap(**TERRAIN_DROP_MAP).numpy()


def _height_at(heights, origin, cell, x, z) -> float:
    from ..terrain.heightmap import sample_height_bilinear

    h, _ = sample_height_bilinear(
        torch.as_tensor(heights), origin, cell,
        torch.tensor(x, dtype=torch.float32),
        torch.tensor(z, dtype=torch.float32))
    return float(h)


def add_terrain_drop(b, heights, cell_size: float = TERRAIN_DROP_CELL):
    """examples/showcase.py:110-123's physics: the heightmap (friction
    0.7; its samples `cell_size` apart from TERRAIN_DROP_ORIGIN) and
    TERRAIN_DROP_BODIES bodies at numpy `default_rng(0)` x / z in [-6, 6],
    3 m + 0.5 m per body above the ground, alternating boxes and spheres
    of TERRAIN_DROP_HALF (friction 0.7).  Finalize with the defaults
    (bilinear terrain rows)."""
    b.add_terrain(heights, origin=TERRAIN_DROP_ORIGIN, cell_size=cell_size,
                  friction=0.7)
    rng = np.random.default_rng(0)
    bodies = []
    for i in range(TERRAIN_DROP_BODIES):
        x, z = rng.uniform(-6, 6, 2)
        y = _height_at(heights, TERRAIN_DROP_ORIGIN, cell_size, x, z)
        body = b.add_body(position=(x, y + 3.0 + i * 0.5, z))
        if i % 2 == 0:
            b.add_box_collider(body, (TERRAIN_DROP_HALF,) * 3, friction=0.7)
        else:
            b.add_sphere_collider(body, TERRAIN_DROP_HALF, friction=0.7)
        bodies.append(body)
    return {"bodies": bodies}


def ridge_heights() -> np.ndarray:
    """A 9 x 9 ridge along z, crest 2.0 at x = 4, slopes of 0.5."""
    i = np.arange(9, dtype=np.float32)
    return np.broadcast_to((2.0 - 0.5 * np.abs(i - 4.0))[:, None],
                           (9, 9)).copy()


RIDGE_BOX_HALF = (1.5, 0.1, 0.5)


def add_ridge(b):
    """tests/test_heightmap_mip.py:138-161: the 1.5 x 0.1 x 0.5 box
    (friction 0.9) dropped from 2.6 m onto the ridge's crest; finalize with
    terrain_collision="triangles".  On the crest the box rests at ~2.1 m;
    the vertex-only narrowphase lets it sink to ~1.45."""
    body = b.add_body(position=(4.0, 2.6, 4.0), linear_damping=0.2,
                      angular_damping=0.5)
    b.add_box_collider(body, RIDGE_BOX_HALF, friction=0.9)
    b.add_terrain(ridge_heights(), origin=(0.0, 0.0, 0.0), cell_size=1.0)
    return {"box": body}


# tests/test_cloth.py:87-129: a 2 x 2 m cloth of mass 1, damping 1,
# stepped at 120 Hz with 2 position iterations and a 1 cm margin.
CLOTH_SIZE, CLOTH_MASS, CLOTH_DAMPING = 2.0, 1.0, 1.0
CLOTH_DT = 1.0 / 120.0
CLOTH_ITERATIONS, CLOTH_MARGIN = 2, 0.01
CLOTH_BALL_VEL = (1.5, 0.0, 0.0)
CLOTH_BALL_RADIUS = 0.4


def add_cloth_colliders(b):
    """tests/test_cloth.py's scene with a capsule added: the plane at
    y = -3, a sphere of radius 0.4 at (-2, -0.8, -0.5) free of gravity and
    damping (set its velocity to CLOTH_BALL_VEL: it rolls under the cloth),
    and a capsule along x below the cloth's pinned edge on a body free of
    gravity (zero velocity: it stays).  Both bodies share a no-collide
    group, so the scene has plane rows only."""
    b.add_static_plane((0, 1, 0), -3.0)
    ball = b.add_body(position=(-2.0, -0.8, -0.5), gravity_factor=0.0,
                      linear_damping=0.0)
    b.add_sphere_collider(ball, radius=CLOTH_BALL_RADIUS)
    bar = b.add_body(position=(0.0, -1.6, -0.3), gravity_factor=0.0)
    b.add_capsule_collider(bar, 0.15, 0.6, rotation=_Y_TO_X)
    group = b.new_no_collide_group()
    b.set_no_collide_group(ball, group)
    b.set_no_collide_group(bar, group)
    return {"ball": ball, "bar": bar}


# examples/vehicle_terrain.py: rolling terrain of small amplitude against
# the wheels' radius, the vehicle 0.85 m above the ground at the origin.
VEHICLE_TERRAIN_MAP = dict(resolution=49, world_size=48.0, amplitude=1.2,
                           noise_scale=0.05, seed=11)
VEHICLE_TERRAIN_ORIGIN = (-24.0, 0.0, -24.0)
VEHICLE_TERRAIN_CELL = 1.0


def vehicle_terrain_heights() -> np.ndarray:
    from ..terrain.heightmap import generate_heightmap

    return generate_heightmap(**VEHICLE_TERRAIN_MAP).numpy()


def add_vehicle_terrain(b, heights):
    """The vehicle's terrain (friction 1); returns the chassis position
    (x, y, z) examples/vehicle_terrain.py builds the vehicle at."""
    b.add_terrain(heights, origin=VEHICLE_TERRAIN_ORIGIN,
                  cell_size=VEHICLE_TERRAIN_CELL, friction=1.0)
    h0 = _height_at(heights, VEHICLE_TERRAIN_ORIGIN, VEHICLE_TERRAIN_CELL,
                    0.0, 0.0)
    return (0.0, h0 + 0.85, 0.0)


# examples/flythrough.py:63-77: the pile's bodies and their colliders.
FLYTHROUGH_BODIES = 18
FLYTHROUGH_BOX_HALF = 0.35
FLYTHROUGH_SPHERE_RADIUS = 0.33


def add_flythrough_pile(b, seed: int = 4):
    """examples/flythrough.py's pile: a plane of friction 0.8 and 18 bodies
    at heights 1.2 + 0.75 i over a 3.2 m square (x and z drawn by numpy's
    `default_rng(seed)`, the script's seed 4 by default), every third a
    sphere (restitution 0.35), the others boxes (friction 0.7).  Returns the
    bodies' kinds ("box" or "sphere") in body order."""
    b.add_static_plane((0, 1, 0), 0.0, friction=0.8)
    rng = np.random.default_rng(seed)
    kinds = []
    for i in range(FLYTHROUGH_BODIES):
        kind = "box" if i % 3 else "sphere"
        pos = (float(rng.uniform(-1.6, 1.6)), 1.2 + 0.75 * i,
               float(rng.uniform(-1.6, 1.6)))
        body = b.add_body(position=pos)
        if kind == "box":
            b.add_box_collider(body, (FLYTHROUGH_BOX_HALF,) * 3, friction=0.7)
        else:
            b.add_sphere_collider(body, radius=FLYTHROUGH_SPHERE_RADIUS,
                                  restitution=0.35)
        kinds.append(kind)
    return kinds
