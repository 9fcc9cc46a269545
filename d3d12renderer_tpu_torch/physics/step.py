"""The physics step (counterpart of ``d3d12renderer_tpu/physics/step.py``).

Per substep, unless the fused whole-substep kernel takes it
(`substep_cuda.make_fused_substep`, for supported archetypes on CUDA
tensors): collider poses -> narrowphase (plane rows, terrain rows, the
collider-pair buckets, the runtime broadphase's rows) -> force fields,
gravity, damping and force integration -> contact and joint prep -> the
solve -> semi-implicit Euler.
The solve is the colored one (the CUDA kernel for CUDA tensors) in
contact_mode "colored"; in "split_jacobi" and "runtime_gs" each of the
`solver_iterations` iterations runs the joints' colored sweep and then the
contact mode's solve, in plain PyTorch, as the JAX package does in XLA.
The scene batch is the leading axis of every state tensor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import maths as m
from . import (broadphase, collide, events, joints as joints_mod, solver,
               solver_cuda, substep_cuda)
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


@dataclass
class SubstepPrep:
    """Everything the solve of one substep reads."""

    contacts: Optional[ContactTable]
    contact_prep: Optional[solver.ContactPrep]
    joint_preps: Tuple[dict, ...]
    vel1: torch.Tensor                    # (B, N+1, 3) after forces
    omega1: torch.Tensor
    # runtime_gs: each row's color (B, P).
    contact_colors: Optional[torch.Tensor] = None


CONTACT_MODES = ("colored", "split_jacobi", "runtime_gs")


def _check_settings(settings: PhysicsSettings):
    if settings.fused_substep not in ("auto", "force", "off"):
        raise ValueError("fused_substep must be 'auto', 'force' or 'off', "
                         f"not {settings.fused_substep!r}")
    if settings.contact_mode not in CONTACT_MODES:
        raise ValueError(f"contact_mode must be one of {CONTACT_MODES}, not "
                         f"{settings.contact_mode!r}")
    if settings.solver_backend not in ("auto", "kernel", "plain"):
        raise ValueError("solver_backend must be 'auto', 'kernel' or 'plain', "
                         f"not {settings.solver_backend!r}")


def substep_prep(arch: SceneArchetype, state: BodyState, dt: float,
                 settings: PhysicsSettings, motor_overrides=None) -> SubstepPrep:
    """Contacts, force integration and constraint prep of one substep."""
    mode = settings.contact_mode
    if arch.sap_neighbors > 0 and mode == "colored":
        raise ValueError(
            "runtime broadphase (finalize(broadphase='sap')) produces dynamic "
            "pair sets that cannot be statically colored; use "
            "PhysicsSettings(contact_mode='split_jacobi') (or 'runtime_gs' "
            "for validation runs)")
    # Contacts from the pre-integration poses.
    contacts = collide.generate_contacts(arch, state)
    force = state.force
    if arch.ff_center.shape[0] > 0:
        force = force + events.apply_force_fields(arch, state)
    vel, omega, inv_inertia_w = integrate_forces(
        arch, state.pos, state.rot, state.vel, state.omega, force,
        state.torque, dt, settings.global_force_field)

    # N+1 slots: the static world body last.
    pos1 = _append_world(state.pos)
    vel1 = _append_world(vel)
    omega1 = _append_world(omega)
    ii_w1 = _append_world(inv_inertia_w)
    if arch.sap_neighbors > 0 and arch.sap_active_budget > 0:
        # Only the manifolds that hit go on to prep and the solve.
        contacts = broadphase.compact_active(contacts,
                                             arch.sap_active_budget)
    inv_mass1 = arch.inv_mass
    contact_prep = colors = None
    if contacts is not None and contacts.active.shape[-1] > 0:
        if mode == "split_jacobi":
            # Effective masses see each body split into `deg` pieces, so
            # each row under-corrects by 1/deg; impulses apply at the true
            # masses.
            deg = solver.contact_degrees(contacts, arch.num_bodies + 1)
            contact_prep = solver.prep_contacts_full(
                contacts, pos1, inv_mass1, ii_w1, vel1, omega1, dt,
                inv_mass_eff=inv_mass1 * deg,
                inv_inertia_eff=ii_w1 * deg[..., None, None])
        else:
            contact_prep = solver.prep_contacts_full(
                contacts, pos1, inv_mass1, ii_w1, vel1, omega1, dt)
        if mode == "runtime_gs":
            batch = pos1.shape[0]
            ia = contacts.body_a.expand(batch, -1)
            ib = contacts.body_b.expand(batch, -1)
            colors, _ = solver.runtime_color(
                ia, ib, contacts.active, inv_mass1[ia] > 0, inv_mass1[ib] > 0,
                arch.num_bodies + 1, settings.runtime_gs_colors)

    rot1 = _append_world(state.rot)
    rot1[:, -1, 3] = 1.0
    ctx = joints_mod.JointContext(
        pos1=pos1, rot1=rot1, inv_mass1=inv_mass1, ii_w1=ii_w1,
        local_cog1=arch.local_cog, dt=dt)
    joint_preps = joints_mod.prep_all(arch, ctx, motor_overrides)
    return SubstepPrep(contacts=contacts, contact_prep=contact_prep,
                       joint_preps=joint_preps, vel1=vel1, omega1=omega1,
                       contact_colors=colors)


def solve_iterations(arch: SceneArchetype, sp: SubstepPrep,
                     settings: PhysicsSettings):
    """The split_jacobi / runtime_gs solve: per iteration the joints'
    colored sweep, then the contacts.  Returns (vel1, omega1)."""
    vel1, omega1 = sp.vel1.clone(), sp.omega1.clone()
    batch = vel1.shape[0]
    plans = joints_mod.color_plans_of(arch, vel1.device)
    impulses = joints_mod.init_impulses(arch, batch, vel1.dtype, vel1.device)
    prep = sp.contact_prep
    if prep is not None:
        imp_n = vel1.new_zeros(prep.pmask.shape)
        imp_t = vel1.new_zeros(prep.pmask.shape)
    for _ in range(settings.solver_iterations):
        joints_mod.solve_all_one_iteration(arch, plans, sp.joint_preps,
                                           impulses, vel1, omega1)
        if prep is None:
            continue
        if settings.contact_mode == "split_jacobi":
            solver.solve_contacts_split_jacobi(prep, vel1, omega1, imp_n,
                                               imp_t)
        else:
            solver.solve_contacts_runtime_gs(prep, sp.contact_colors,
                                             settings.runtime_gs_colors, vel1,
                                             omega1, imp_n, imp_t)
    return vel1, omega1


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
    if settings.contact_mode != "colored":
        vel1, omega1 = solve_iterations(arch, sp, settings)
    elif arch.joints or sp.contact_prep is not None:
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
                 num_substeps: Optional[int] = None, motor_overrides=None,
                 collect_events: bool = False, prev_active=None):
    """Step every scene by `dt` in fixed-rate substeps (at most
    `settings.max_substeps`).  Returns (state, contacts of the last
    substep).

    `collect_events=True` also returns the `events.CollisionEvents` folded
    over the substeps: begin / end found per substep against `prev_active`
    (the previous frame's `active`), the approach speed from the
    pre-solve velocities of the substep the contact began in.  That route
    takes the unfused step, whose contact table it reads, as in the JAX
    package."""
    if num_substeps is None:
        num_substeps = max(1, round(dt * settings.frame_rate))
        num_substeps = min(num_substeps, settings.max_substeps)
    h = 1.0 / settings.frame_rate
    contacts = folded = None
    for _ in range(num_substeps):
        if collect_events:
            # A zero row for the world slot, which plane and terrain rows
            # name as body A.
            vel0, omega0, pos0 = (_append_world(x) for x in (
                state.vel, state.omega, state.pos))
        state, contacts = physics_substep(arch, state, h, settings,
                                          motor_overrides,
                                          allow_fused=not collect_events)
        if collect_events and contacts is not None:
            ev = events.collision_events(contacts, vel0, omega0, prev_active,
                                         pos=pos0)
            prev_active = ev.active
            folded = ev if folded is None else events.CollisionEvents(
                begin=folded.begin | ev.begin,
                end=folded.end | ev.end,
                active=ev.active,
                approach_speed=torch.maximum(folded.approach_speed,
                                             ev.approach_speed))
    if collect_events:
        return state, contacts, folded
    return state, contacts


def physics_step_interpolated(arch: SceneArchetype, state: BodyState,
                              settings: PhysicsSettings, dt: float,
                              accumulator: float = 0.0, motor_overrides=None):
    """Fixed-rate substeps with the leftover time carried over and a render
    pose between the last two substeps' poses.  `dt` and `accumulator` are
    Python floats.  Returns (state, contacts, new accumulator, (render_pos,
    render_rot)); more than `settings.max_substeps` substeps of time (a
    dropped frame) runs max_substeps and keeps only the fraction of a
    substep left over."""
    h = 1.0 / settings.frame_rate
    total = accumulator + dt
    num_substeps = int(total / h)
    if num_substeps > settings.max_substeps:
        num_substeps = settings.max_substeps
        total = num_substeps * h + (total % h)
    new_accumulator = total - num_substeps * h

    pos0, rot0 = state.pos, state.rot
    contacts = None
    for _ in range(num_substeps):
        pos0, rot0 = state.pos, state.rot
        state, contacts = physics_substep(arch, state, h, settings,
                                          motor_overrides)

    alpha = float(np.float32(new_accumulator / h))
    render_pos = pos0 + (state.pos - pos0) * alpha
    # nlerp on the near hemisphere.
    dot = torch.sum(rot0 * state.rot, -1, keepdim=True)
    rot1 = torch.where(dot < 0, -state.rot, state.rot)
    render_rot = m.normalize(rot0 + (rot1 - rot0) * alpha)
    return state, contacts, new_accumulator, (render_pos, render_rot)


def make_batched_step(arch: SceneArchetype, settings: PhysicsSettings,
                      dt: float):
    """`step(state) -> state`: one `physics_step` of `dt` over a batched
    state.  Every state of the port carries the scene axis already, so this
    is the step itself; kept for the JAX package's API."""

    def step(batched_state: BodyState) -> BodyState:
        return physics_step(arch, batched_state, settings, dt)[0]

    return step
