"""The plain physics step: per substep, collider poses -> narrowphase
(plane rows and the collider-pair buckets) -> gravity, damping and force
integration -> contact and joint prep -> the colored sequential-impulse
solve as per-color PyTorch ops -> semi-implicit Euler.  The scene batch is
the leading axis of every state tensor."""

from __future__ import annotations


import numpy as np
import torch

from ..core import maths as m
from . import collide, joints as joints_mod, solver
from .types import BodyState, PhysicsSettings, SceneArchetype


def _append_world(x):
    """(B, N, ...) -> (B, N+1, ...) with a zero row for the world body."""
    return torch.cat([x, x.new_zeros(x.shape[:1] + (1,) + x.shape[2:])], dim=1)


def integrate_forces(arch: SceneArchetype, pos, rot, vel, omega, force, torque,
                     dt, global_force_field):
    """Gravity, external forces and damping.  Returns (vel, omega, world
    inverse inertia (B, N, 3, 3))."""
    inv_mass = arch.inv_mass[:-1]
    gravity = torch.zeros_like(vel)
    gravity[..., 1] = m.GRAVITY * arch.gravity_factor[:-1]
    rotm = m.quat_to_mat3(rot)
    inv_inertia_w = rotm @ arch.inv_inertia[:-1] @ rotm.transpose(-1, -2)
    force = force + m.constant(tuple(global_force_field), vel.dtype,
                               vel.device)
    moving = (inv_mass > 0.0)[:, None]
    lin_acc = (gravity + force * inv_mass[:, None]) * moving
    ang_acc = m.mat3_vec(inv_inertia_w, torque)
    vel = vel + lin_acc * dt
    omega = omega + ang_acc * dt
    vel = vel / (1.0 + dt * arch.linear_damping[:-1, None])
    omega = omega / (1.0 + dt * arch.angular_damping[:-1, None])
    return vel, omega, inv_inertia_w


def integrate_velocities(pos, rot, vel, omega, dt):
    """Semi-implicit Euler."""
    return pos + vel * dt, m.quat_integrate(rot, omega, dt)


def contact_bodies(arch: SceneArchetype):
    """(body_a, body_b) numpy arrays of every contact row, in the order of
    `collide.generate_contacts`: plane rows (A the world slot), then the
    buckets."""
    ib = [arch.vs_plane_body.cpu().numpy(), arch.vs_terrain_body.cpu().numpy()]
    ia = [np.full_like(b, arch.world_body) for b in ib]
    for bucket in arch.contact_buckets:
        ia.append(bucket.body_a.cpu().numpy())
        ib.append(bucket.body_b.cpu().numpy())
    return np.concatenate(ia), np.concatenate(ib)


def _color_plans(arch: SceneArchetype, num_pairs: int, device):
    key = ("plain_plans", num_pairs, str(device))
    if key not in arch.cache:
        dynamic = (arch.inv_mass > 0.0).cpu().numpy()
        contact_plans = []
        if num_pairs > 0:
            ia, ib = (torch.as_tensor(x, device=device)
                      for x in contact_bodies(arch))
            contact_plans = solver.color_plans(
                arch.contact_color_indices, ia, ib, dynamic)
        arch.cache[key] = (joints_mod.color_plans_of(arch, device),
                           contact_plans)
    return arch.cache[key]


def colored_solve(arch: SceneArchetype, num_pairs: int, iterations: int,
                  joint_preps, contact_prep, vel1, omega1):
    """`iterations` sweeps of the joint tables, then the contact rows color
    by color."""
    batch = vel1.shape[0]
    joint_plans, contact_plans = _color_plans(arch, num_pairs, vel1.device)
    vel, omega = vel1.clone(), omega1.clone()
    impulses = joints_mod.init_impulses(arch, batch, vel1.dtype, vel1.device)
    imp_n = vel1.new_zeros((batch, num_pairs, 4))
    imp_t = vel1.new_zeros((batch, num_pairs, 4))
    for _ in range(iterations):
        joints_mod.solve_all_one_iteration(arch, joint_plans, joint_preps,
                                           impulses, vel, omega)
        if contact_prep is not None:
            solver.solve_contacts_colored(contact_prep, contact_plans, vel,
                                          omega, imp_n, imp_t)
    return vel, omega


def physics_substep(arch: SceneArchetype, state: BodyState, dt: float,
                    settings: PhysicsSettings, motor_overrides=None):
    """One substep of every scene: returns (new state, contacts)."""
    if settings.contact_mode != "colored":
        raise NotImplementedError("the frozen reference solves colored only")
    if arch.ff_center.shape[0] > 0:
        raise NotImplementedError("the frozen reference has no force fields")
    n = arch.num_bodies
    contacts = collide.generate_contacts(arch, state)
    vel, omega, inv_inertia_w = integrate_forces(
        arch, state.pos, state.rot, state.vel, state.omega, state.force,
        state.torque, dt, settings.global_force_field)
    pos1 = _append_world(state.pos)
    vel1 = _append_world(vel)
    omega1 = _append_world(omega)
    ii_w1 = _append_world(inv_inertia_w)
    contact_prep = None
    if contacts is not None and contacts.active.shape[-1] > 0:
        contact_prep = solver.prep_contacts_full(
            contacts, pos1, arch.inv_mass, ii_w1, vel1, omega1, dt)
    rot1 = _append_world(state.rot)
    rot1[:, -1, 3] = 1.0
    ctx = joints_mod.JointContext(
        pos1=pos1, rot1=rot1, inv_mass1=arch.inv_mass, ii_w1=ii_w1,
        local_cog1=arch.local_cog, dt=dt)
    joint_preps = joints_mod.prep_all(arch, ctx, motor_overrides)
    if arch.joints or contact_prep is not None:
        num_pairs = 0 if contacts is None else contacts.body_a.shape[0]
        vel1, omega1 = colored_solve(arch, num_pairs,
                                     settings.solver_iterations, joint_preps,
                                     contact_prep, vel1, omega1)
    vel, omega = vel1[:, :n], omega1[:, :n]
    pos, rot = integrate_velocities(state.pos, state.rot, vel, omega, dt)
    return state.replace(pos=pos, rot=rot, vel=vel, omega=omega,
                         force=torch.zeros_like(state.force),
                         torque=torch.zeros_like(state.torque)), contacts


def physics_step(arch: SceneArchetype, state: BodyState,
                 settings: PhysicsSettings, dt: float,
                 motor_overrides=None):
    """Step every scene by `dt` in fixed-rate substeps (at most
    `settings.max_substeps`).  Returns (state, contacts of the last
    substep)."""
    num_substeps = max(1, round(dt * settings.frame_rate))
    num_substeps = min(num_substeps, settings.max_substeps)
    contacts = None
    for _ in range(num_substeps):
        state, contacts = physics_substep(arch, state,
                                          1.0 / settings.frame_rate, settings,
                                          motor_overrides)
    return state, contacts
