"""The ragdoll locomotion env's step, plain: the poke, one physics step
(plane contacts, motors, the 30-iteration colored solve, integration), the
fall check, the imitation reward, the observation and the auto-reset of
fallen envs.  Observation (66): torso velocity, 6 body-part positions and
velocities in the torso ground frame, the smoothed action.  Action (27): per
cone-twist {twist target, swing target, swing axis angle} x 7, per hinge
{target angle} x 6.  Every tensor carries a leading environment axis B.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core import maths as m
from ..device import resolve_device
from ..models import ragdoll as rd
from ..physics.builder import SceneBuilder
from ..physics.step import physics_step
from ..physics.types import BodyState, PhysicsSettings

NUM_PARTS = 14
ACTION_SIZE = rd.NUM_CONE_TWIST * 3 + rd.NUM_HINGE  # 27
ACTION_SMOOTHING = 0.1
POKE_PROBABILITY = 0.02
POKE_STRENGTH = 1000.0
FRAME_RATE = 60

OBS_PARTS = ["left_toes", "right_toes", "torso", "head",
             "left_lower_arm", "right_lower_arm"]


class LocoEnv:
    """`step(bodies, last_action, action, poke)` over B envs on `device`,
    at 60 Hz with the default physics settings."""

    def __init__(self, settings: Optional[PhysicsSettings] = None,
                 self_collision: bool = False, device="cuda"):
        self.device = resolve_device(device)
        b = SceneBuilder()
        b.add_static_plane((0.0, 1.0, 0.0), 0.0, friction=1.0, restitution=0.1)
        info = rd.build_humanoid_ragdoll(
            b, hip_position=(0.0, 1.25, 0.0), self_collision=self_collision)
        self.arch, self._state0 = b.finalize(device=self.device)
        self.info = info
        self.settings = settings or PhysicsSettings(frame_rate=FRAME_RATE)

        self._table_index = {t.kind: k for k, t in enumerate(self.arch.joints)}
        self._num_tables = len(self.arch.joints)

        def i64(x):
            return torch.as_tensor(x, dtype=torch.int64, device=self.device)

        self.part_idx = i64(info.body_indices)
        self.parent_idx = i64(rd.BODY_PART_PARENTS)
        self.local_points = torch.as_tensor(info.local_points,
                                            device=self.device)
        self.obs_part_slots = i64([rd.BODY_PARTS.index(n) for n in OBS_PARTS])
        # Built once: a tensor made from a Python list on the card is a
        # pageable copy that waits for the card's queue, once per step.
        self._poke_offset = torch.tensor([0.0, 0.2, 0.0], device=self.device)
        self._head = rd.BODY_PARTS.index("head")

        # Imitation targets from the initial standing pose.
        p0 = self._state0
        self.target_points = self._world_points(p0)[0]          # (14, 6, 3)
        self.target_velocities = torch.zeros_like(self.target_points)
        self.target_local_rot = self._local_rotations(p0.rot)[0]  # (14, 4)
        # Body slots as Python ints: indexing with a 0-d device tensor reads
        # it back to the host.
        self._head_body = int(self.part_idx[self._head])
        self._torso_body = int(self.part_idx[0])
        self.head_target_height = float(p0.pos[0, self._head_body, 1])
        self.torso_velocity_target = torch.zeros(3, device=self.device)
        self._obs0 = self._get_obs(
            p0, torch.zeros((1, ACTION_SIZE), device=self.device))[0]

    # -- helpers -----------------------------------------------------------

    def _world_points(self, bodies: BodyState):
        """(B, 14, 6, 3) world positions of each part's 6 sample points."""
        idx = self.part_idx
        cog = bodies.pos[:, idx]
        rot = bodies.rot[:, idx]
        rel = self.local_points - self.arch.local_cog[idx][:, None, :]
        return cog[:, :, None, :] + m.quat_rotate(rot[:, :, None, :], rel)

    def _local_rotations(self, rot):
        """(B, 14, 4) rotation of each part relative to its parent."""
        idx = self.part_idx
        q = rot[:, idx]
        ident = m.constant((0.0, 0.0, 0.0, 1.0), rot.dtype, rot.device)
        qp = torch.where((self.parent_idx >= 0)[:, None],
                         rot[:, idx[torch.clamp(self.parent_idx, min=0)]],
                         ident)
        return m.quat_mul(q, m.quat_conj(qp))

    def _get_obs(self, bodies: BodyState, last_action):
        torso = self._torso_body
        origin = bodies.pos[:, torso] * m.constant(
            (1.0, 0.0, 1.0), bodies.pos.dtype, self.device)
        slots = self.part_idx[self.obs_part_slots]
        pos = bodies.pos[:, slots] - origin[:, None, :]
        vel = bodies.vel[:, slots]
        pv = torch.cat([pos, vel], dim=-1).reshape(pos.shape[0], -1)
        return torch.cat([bodies.vel[:, torso], pv, last_action], dim=-1)

    def _has_fallen(self, bodies: BodyState):
        return bodies.pos[:, self._head_body, 1] < 1.0

    def _reward(self, bodies: BodyState):
        idx = self.part_idx
        pts = self._world_points(bodies)
        pos_err = torch.sum(m.length(pts - self.target_points), dim=(1, 2))

        cog = bodies.pos[:, idx]
        pt_vel = bodies.vel[:, idx][:, :, None, :] + m.cross(
            bodies.omega[:, idx][:, :, None, :], pts - cog[:, :, None, :])
        vel_err = torch.sum(m.length(pt_vel - self.target_velocities),
                            dim=(1, 2))

        diff = m.quat_mul(self.target_local_rot,
                          m.quat_conj(self._local_rotations(bodies.rot)))
        rot_err = torch.sum(
            2.0 * torch.acos(torch.clamp(diff[..., 3], -1.0, 1.0)), dim=-1)

        vcm_err = m.length(bodies.vel[:, self._torso_body]
                           - self.torso_velocity_target)

        n = float(NUM_PARTS)
        rp = torch.exp(-10.0 / n * pos_err)
        rv = torch.exp(-1.0 / n * vel_err)
        rlocal = torch.exp(-10.0 / n * rot_err)
        rvcm = torch.exp(-vcm_err)

        head_y = bodies.pos[:, self._head_body, 1]
        fall = torch.clamp(1.3 - 1.4 * (self.head_target_height - head_y),
                           0.0, 1.0)
        return fall * (rp + rv + rlocal + rvcm)

    def _motor_overrides(self, smoothed_action):
        """(B, 27) action -> per-table {param: (B, J)} overrides."""
        batch = smoothed_action.shape[0]
        ct = smoothed_action[:, :rd.NUM_CONE_TWIST * 3].reshape(
            batch, rd.NUM_CONE_TWIST, 3)
        overrides = [None] * self._num_tables
        overrides[self._table_index["cone_twist"]] = {
            "twist_target": ct[..., 0],
            "swing_target": ct[..., 1],
            "swing_axis_angle": ct[..., 2],
        }
        overrides[self._table_index["hinge"]] = {
            "motor_target": smoothed_action[:, rd.NUM_CONE_TWIST * 3:]}
        return tuple(overrides)

    def draw_poke(self, generator: torch.Generator, batch: int):
        """Random (do, part, theta) per env from `generator`."""
        dev = self.device
        do = torch.rand(batch, generator=generator, device=dev) < POKE_PROBABILITY
        part = torch.randint(0, NUM_PARTS, (batch,), generator=generator,
                             device=dev)
        theta = torch.rand(batch, generator=generator, device=dev) * (2.0 * math.pi)
        return do, part, theta

    def apply_poke(self, bodies: BodyState, do, part, theta) -> BodyState:
        """Horizontal push of POKE_STRENGTH on body part `part` of each env
        where `do`, applied 0.2 m above its COG, in direction theta."""
        batch = do.shape[0]
        direction = torch.stack(
            [torch.cos(theta), torch.zeros_like(theta), torch.sin(theta)], -1)
        body = self.part_idx[part]
        envs = torch.arange(batch, device=self.device)
        bpos = bodies.pos[envs, body]
        point = bpos + self._poke_offset
        force = direction * POKE_STRENGTH * do[:, None]
        torque = m.cross(point - bpos, force)
        f, t = bodies.force.clone(), bodies.torque.clone()
        f[envs, body] += force
        t[envs, body] += torque
        return bodies.replace(force=f, torque=t)

    # -- public API --------------------------------------------------------

    def step_core(self, bodies: BodyState, smoothed):
        """Physics, then done / reward / obs and auto-reset of fallen envs.
        Also returns the head's height before the reset; `active_points`
        keeps the step's active contact points, summed over the envs (a
        tensor on the device: no host read inside the step)."""
        bodies, contacts = physics_step(
            self.arch, bodies, self.settings, 1.0 / FRAME_RATE,
            motor_overrides=self._motor_overrides(smoothed))
        self.active_points = (torch.zeros((), device=self.device)
                              if contacts is None else
                              (contacts.pmask & contacts.active[..., None]).sum())
        head_y = bodies.pos[:, self._head_body, 1]
        done = self._has_fallen(bodies)
        reward = torch.where(done, torch.zeros_like(done, dtype=torch.get_default_dtype()),
                             self._reward(bodies))
        obs = self._get_obs(bodies, smoothed)
        s0 = self._state0
        d3 = done[:, None, None]
        bodies = BodyState(*(torch.where(d3, a, b) for a, b in zip(
            (s0.pos, s0.rot, s0.vel, s0.omega, s0.force, s0.torque),
            (bodies.pos, bodies.rot, bodies.vel, bodies.omega, bodies.force,
             bodies.torque))))
        obs = torch.where(done[:, None], self._obs0, obs)
        return bodies, obs, reward, done, head_y

    def step(self, bodies: BodyState, last_action, action, poke):
        """One 60 Hz control step of every env from `poke` = (do, part,
        theta); fallen envs auto-reset.  Returns (obs, bodies, smoothed
        action, reward, done, head height before the reset)."""
        smoothed = last_action + ACTION_SMOOTHING * (action - last_action)
        bodies = self.apply_poke(bodies, *poke)
        bodies, obs, reward, done, head_y = self.step_core(bodies, smoothed)
        smoothed = torch.where(done[:, None], torch.zeros_like(smoothed),
                               smoothed)
        return obs, bodies, smoothed, reward, done, head_y
