"""The physics step (counterpart of ``d3d12renderer_tpu/physics/step.py``).

Per substep, unless the fused whole-substep kernel takes it
(`substep_cuda.make_fused_substep`, for supported archetypes on CUDA
tensors): collider poses -> plane narrowphase -> gravity, damping and force
integration -> contact and joint prep -> the colored solve (the CUDA kernel
for CUDA tensors) -> semi-implicit Euler.  The scene batch is the leading
axis of every state tensor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..core import maths as m
from . import collide, joints as joints_mod, solver, solver_cuda, substep_cuda
from .narrow import ContactTable
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
    force = force + torch.as_tensor(global_force_field, dtype=vel.dtype,
                                    device=vel.device)
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


@dataclass
class SubstepPrep:
    """Everything the solve of one substep reads."""

    contacts: Optional[ContactTable]
    contact_prep: Optional[solver.ContactPrep]
    joint_preps: Tuple[dict, ...]
    vel1: torch.Tensor                    # (B, N+1, 3) after forces
    omega1: torch.Tensor


def _check_settings(settings: PhysicsSettings):
    if settings.fused_substep not in ("auto", "force", "off"):
        raise ValueError("fused_substep must be 'auto', 'force' or 'off', "
                         f"not {settings.fused_substep!r}")
    if settings.contact_mode != "colored":
        raise NotImplementedError(
            f"contact_mode={settings.contact_mode!r} is not ported yet "
            "(ROADMAP.md Queue 1: slice 2, split_jacobi/runtime_gs)")
    if settings.solver_backend not in ("auto", "kernel", "plain"):
        raise ValueError("solver_backend must be 'auto', 'kernel' or 'plain', "
                         f"not {settings.solver_backend!r}")


def substep_prep(arch: SceneArchetype, state: BodyState, dt: float,
                 settings: PhysicsSettings, motor_overrides=None) -> SubstepPrep:
    """Contacts, force integration and constraint prep of one substep."""
    # Contacts from the pre-integration poses.
    contacts = collide.generate_contacts(arch, state)
    vel, omega, inv_inertia_w = integrate_forces(
        arch, state.pos, state.rot, state.vel, state.omega, state.force,
        state.torque, dt, settings.global_force_field)

    # N+1 slots: the static world body last.
    pos1 = _append_world(state.pos)
    vel1 = _append_world(vel)
    omega1 = _append_world(omega)
    ii_w1 = _append_world(inv_inertia_w)
    contact_prep = None
    if contacts is not None:
        contact_prep = solver.prep_contacts_full(
            contacts, pos1, arch.inv_mass, ii_w1, vel1, omega1, dt)

    rot1 = _append_world(state.rot)
    rot1[:, -1, 3] = 1.0
    ctx = joints_mod.JointContext(
        pos1=pos1, rot1=rot1, inv_mass1=arch.inv_mass, ii_w1=ii_w1,
        local_cog1=arch.local_cog, dt=dt)
    joint_preps = joints_mod.prep_all(arch, ctx, motor_overrides)
    return SubstepPrep(contacts=contacts, contact_prep=contact_prep,
                       joint_preps=joint_preps, vel1=vel1, omega1=omega1)


def physics_substep(arch: SceneArchetype, state: BodyState, dt: float,
                    settings: PhysicsSettings, motor_overrides=None,
                    allow_fused: bool = True):
    """One substep of every scene: returns (new_state, contacts).  Where the
    fused route takes the substep, the contacts never leave the kernel and
    come back as None, as in the JAX package."""
    _check_settings(settings)
    if allow_fused and settings.fused_substep != "off":
        fused = substep_cuda.make_fused_substep(
            arch, settings, dt, motor_overrides, state.pos.device)
        if fused is not None:
            return fused(state, motor_overrides), None
    n = arch.num_bodies
    sp = substep_prep(arch, state, dt, settings, motor_overrides)
    vel1, omega1 = sp.vel1, sp.omega1
    if arch.joints or sp.contact_prep is not None:
        num_pairs = 0 if sp.contacts is None else sp.contacts.body_a.shape[0]
        solve = solver_cuda.make_colored_solver(
            arch, num_pairs, settings.solver_iterations, settings.solver_backend)
        vel1, omega1 = solve(sp.joint_preps, sp.contact_prep, vel1, omega1)
    vel, omega = vel1[:, :n], omega1[:, :n]
    pos, rot = integrate_velocities(state.pos, state.rot, vel, omega, dt)
    new_state = state.replace(pos=pos, rot=rot, vel=vel, omega=omega,
                              force=torch.zeros_like(state.force),
                              torque=torch.zeros_like(state.torque))
    return new_state, sp.contacts


def physics_step(arch: SceneArchetype, state: BodyState,
                 settings: PhysicsSettings, dt: float,
                 num_substeps: Optional[int] = None, motor_overrides=None):
    """Step every scene by `dt` in fixed-rate substeps (at most
    `settings.max_substeps`).  Returns (state, contacts of the last substep)."""
    if num_substeps is None:
        num_substeps = max(1, round(dt * settings.frame_rate))
        num_substeps = min(num_substeps, settings.max_substeps)
    h = 1.0 / settings.frame_rate
    contacts = None
    for _ in range(num_substeps):
        state, contacts = physics_substep(arch, state, h, settings,
                                          motor_overrides)
    return state, contacts
