"""Cloth against rigid bodies (counterpart of
``d3d12renderer_tpu/physics/cloth_coupling.py``): cloth particles are
projected out of the scene's sphere and capsule colliders at their current
poses, one way (rigid -> cloth), BASELINE config 3.  The cloth state and
the body state share the leading scene axis.
"""

from __future__ import annotations

from ..core import maths as m
from .cloth import (ClothParams, ClothState, collide_capsules,
                    collide_spheres, simulate)
from .collide import collider_world_poses, colliders_of_type
from .types import SHAPE_CAPSULE, SHAPE_SPHERE, BodyState, SceneArchetype


def make_rigid_collide_fn(arch: SceneArchetype, state: BodyState,
                          margin: float = 0.0):
    """`collide_fn(positions) -> positions` for `cloth.simulate` from the
    scene's sphere and capsule colliders at the state's poses, each with
    its own radii; None for a scene with neither.  (The JAX function's
    sphere closure reads the capsules' radii where a scene has both: its
    `radii` is rebound before the closure runs, ROADMAP.md Queue 3.)"""
    wpos, wrot = collider_world_poses(arch, state)
    funcs = []
    si = colliders_of_type(arch, SHAPE_SPHERE)
    if si.numel():
        centers, radii = wpos[:, si], arch.col_size[si, 0]
        funcs.append(lambda p: collide_spheres(p, centers, radii, margin))
    ci = colliders_of_type(arch, SHAPE_CAPSULE)
    if ci.numel():
        cpos, crot = wpos[:, ci], wrot[:, ci]
        half = arch.col_size[ci, 1]
        up = m.constant((0.0, 1.0, 0.0), cpos.dtype, cpos.device)
        axis = m.quat_rotate(crot, up.expand(cpos.shape))
        p0 = cpos - axis * half[:, None]
        p1 = cpos + axis * half[:, None]
        radii_c = arch.col_size[ci, 0]
        funcs.append(lambda p: collide_capsules(p, p0, p1, radii_c, margin))
    if not funcs:
        return None

    def collide(p):
        for f in funcs:
            p = f(p)
        return p

    return collide


def step_cloth_with_bodies(params: ClothParams, cloth_state: ClothState,
                           arch: SceneArchetype, body_state: BodyState,
                           dt: float, position_iterations: int = 2,
                           margin: float = 0.01) -> ClothState:
    """One coupled step: the cloth simulated against the bodies' current
    poses."""
    fn = make_rigid_collide_fn(arch, body_state, margin)
    return simulate(params, cloth_state, dt,
                    position_iterations=position_iterations, collide_fn=fn)
