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
"""

from __future__ import annotations

import math

import numpy as np

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
