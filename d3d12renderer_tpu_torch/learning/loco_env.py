"""Batched ragdoll locomotion environment (counterpart of
``d3d12renderer_tpu/learning/loco_env.py``).

Observation (66): torso velocity, 6 body-part positions and velocities in the
torso ground frame, the smoothed action.  Action (27): per cone-twist
{twist target, swing target, swing axis angle} x 7, per hinge {target
angle} x 6.  Reward: imitation of the standing pose times a fall factor.
Every tensor carries a leading environment axis B; randomness (the pokes)
comes from the `torch.Generator` held in the `EnvState`.

On CUDA tensors with the default settings the whole env step after the
poke (physics substep, fall check, reward, obs, auto-reset) is one launch of
the fused kernel (`physics/substep_cuda.py`); `_step_core` is its plain
version and the route everywhere else.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch

from ..core import maths as m
from ..models import ragdoll as rd
from ..physics import substep_cuda
from ..physics.builder import SceneBuilder
from ..physics.step import physics_step
from ..physics.types import BodyState, PhysicsSettings

NUM_PARTS = 14
ACTION_SIZE = rd.NUM_CONE_TWIST * 3 + rd.NUM_HINGE  # 27
STATE_SIZE = 3 + 6 * 6 + ACTION_SIZE                # 66

ACTION_SMOOTHING = 0.1
POKE_PROBABILITY = 0.02
POKE_STRENGTH = 1000.0
FRAME_RATE = 60

OBS_PARTS = ["left_toes", "right_toes", "torso", "head",
             "left_lower_arm", "right_lower_arm"]


@dataclass
class EnvState:
    bodies: BodyState
    last_action: torch.Tensor       # (B, 27) smoothed
    generator: torch.Generator      # draws the pokes
    steps: torch.Tensor             # (B,) int32


class LocoEnv:
    """`reset(batch, generator)` and `step(state, action)` over B envs on
    `device`.  The default settings are the JAX env's,
    `PhysicsSettings(frame_rate=60)`, so `fused_substep="auto"`."""

    def __init__(self, settings: Optional[PhysicsSettings] = None,
                 self_collision: bool = False, device="cpu"):
        self.device = torch.device(device)
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
        self._head = rd.BODY_PARTS.index("head")

        # Imitation targets from the initial standing pose.
        p0 = self._state0
        self.target_points = self._world_points(p0)[0]          # (14, 6, 3)
        self.target_velocities = torch.zeros_like(self.target_points)
        self.target_local_rot = self._local_rotations(p0.rot)[0]  # (14, 4)
        self.head_target_height = float(p0.pos[0, self.part_idx[self._head], 1])
        self.torso_velocity_target = torch.zeros(3, device=self.device)
        self._obs0 = self._get_obs(
            p0, torch.zeros((1, ACTION_SIZE), device=self.device))[0]
        self._fused_step = self._fused_env_step()

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
        ident = torch.tensor([0.0, 0.0, 0.0, 1.0], device=rot.device)
        qp = torch.where((self.parent_idx >= 0)[:, None],
                         rot[:, idx[torch.clamp(self.parent_idx, min=0)]],
                         ident)
        return m.quat_mul(q, m.quat_conj(qp))

    def _get_obs(self, bodies: BodyState, last_action):
        torso = self.part_idx[0]
        origin = bodies.pos[:, torso] * torch.tensor([1.0, 0.0, 1.0],
                                                     device=self.device)
        slots = self.part_idx[self.obs_part_slots]
        pos = bodies.pos[:, slots] - origin[:, None, :]
        vel = bodies.vel[:, slots]
        pv = torch.cat([pos, vel], dim=-1).reshape(pos.shape[0], -1)
        return torch.cat([bodies.vel[:, torso], pv, last_action], dim=-1)

    def _has_fallen(self, bodies: BodyState):
        return bodies.pos[:, self.part_idx[self._head], 1] < 1.0

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

        vcm_err = m.length(bodies.vel[:, idx[0]] - self.torso_velocity_target)

        n = float(NUM_PARTS)
        rp = torch.exp(-10.0 / n * pos_err)
        rv = torch.exp(-1.0 / n * vel_err)
        rlocal = torch.exp(-10.0 / n * rot_err)
        rvcm = torch.exp(-vcm_err)

        head_y = bodies.pos[:, idx[self._head], 1]
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
        point = bpos + torch.tensor([0.0, 0.2, 0.0], device=self.device)
        force = direction * POKE_STRENGTH * do[:, None]
        torque = m.cross(point - bpos, force)
        f, t = bodies.force.clone(), bodies.torque.clone()
        f[envs, body] += force
        t[envs, body] += torque
        return bodies.replace(force=f, torque=t)

    # -- fused whole-env-step kernel -----------------------------------------

    def _action_columns(self):
        """Override column of each runtime motor target: the kernel reads
        the smoothed (B, 27) action itself as its override matrix."""
        ct, h = self._table_index["cone_twist"], self._table_index["hinge"]
        nc = rd.NUM_CONE_TWIST
        return {(ct, "twist_target"): range(0, 3 * nc, 3),
                (ct, "swing_target"): range(1, 3 * nc, 3),
                (ct, "swing_axis_angle"): range(2, 3 * nc, 3),
                (h, "motor_target"): range(3 * nc, 3 * nc + rd.NUM_HINGE)}

    def post_consts(self) -> substep_cuda.PostConsts:
        """The post stage's constants: sample points relative to each part's
        COG, imitation targets, the reset obs and the standing pose."""
        idx = self.part_idx.tolist()
        parent = self.parent_idx.tolist()
        obs_body = self.part_idx[self.obs_part_slots].tolist()
        head = idx[self._head]
        post_i = ([NUM_PARTS, self.local_points.shape[1], len(obs_body),
                   ACTION_SIZE, head, idx[0]] + idx
                  + [idx[p] if p >= 0 else -1 for p in parent] + obs_body
                  + list(range(ACTION_SIZE)))
        rel = self.local_points - self.arch.local_cog[self.part_idx][:, None, :]
        s0 = self._state0
        post_f = torch.cat([
            torch.tensor([self.head_target_height], device=self.device),
            rel.reshape(-1), self.target_points.reshape(-1),
            self.target_local_rot.reshape(-1), self._obs0,
            s0.pos.reshape(-1), s0.rot.reshape(-1), s0.vel.reshape(-1),
            s0.omega.reshape(-1)]).to(torch.float32).contiguous()
        return substep_cuda.PostConsts(
            post_f=post_f,
            post_i=torch.tensor(post_i, dtype=torch.int32, device=self.device),
            n_extra=STATE_SIZE + 2)

    def _fused_env_step(self):
        """`fused(bodies, smoothed) -> (bodies, obs, reward, done)`, the
        whole env step after the poke as one kernel launch on CUDA tensors
        and `_step_core` on CPU tensors; None where the route is not built.
        The kernel integrates one substep of 1/FRAME_RATE, while `_step_core`
        substeps at settings.frame_rate: the route is refused unless the two
        rates agree, as in the JAX package."""
        if substep_cuda.should_build(self.settings, self.device) is None:
            return None
        if float(self.settings.frame_rate) != float(FRAME_RATE):
            return None
        run = substep_cuda.make_kernel_runner(
            self.arch, self.settings, 1.0 / FRAME_RATE, self._action_columns(),
            ACTION_SIZE, post=self.post_consts())
        if run is None:
            return None

        def fused(bodies: BodyState, smoothed):
            if not bodies.pos.is_cuda:
                return self._step_core(bodies, smoothed)
            bodies, extra = run(bodies, smoothed.to(torch.float32).contiguous())
            return (bodies, extra[:, :STATE_SIZE], extra[:, STATE_SIZE],
                    extra[:, STATE_SIZE + 1] > 0.5)

        return fused

    # -- public API --------------------------------------------------------

    def reset(self, batch: int, generator: torch.Generator
              ) -> Tuple[torch.Tensor, EnvState]:
        s0 = self._state0
        bodies = BodyState(*(x.expand((batch,) + x.shape[1:]).clone()
                             for x in (s0.pos, s0.rot, s0.vel, s0.omega,
                                       s0.force, s0.torque)))
        state = EnvState(
            bodies=bodies,
            last_action=torch.zeros((batch, ACTION_SIZE), device=self.device),
            generator=generator,
            steps=torch.zeros(batch, dtype=torch.int32, device=self.device))
        return self._obs0.expand(batch, -1).clone(), state

    def _step_core(self, bodies: BodyState, smoothed):
        """Physics, then done / reward / obs and auto-reset of fallen envs."""
        bodies, _ = physics_step(self.arch, bodies, self.settings,
                                 1.0 / FRAME_RATE,
                                 motor_overrides=self._motor_overrides(smoothed))
        done = self._has_fallen(bodies)
        reward = torch.where(done, torch.zeros_like(done, dtype=torch.float32),
                             self._reward(bodies))
        obs = self._get_obs(bodies, smoothed)
        s0 = self._state0
        d3 = done[:, None, None]
        bodies = BodyState(*(torch.where(d3, a, b) for a, b in zip(
            (s0.pos, s0.rot, s0.vel, s0.omega, s0.force, s0.torque),
            (bodies.pos, bodies.rot, bodies.vel, bodies.omega, bodies.force,
             bodies.torque))))
        obs = torch.where(done[:, None], self._obs0, obs)
        return bodies, obs, reward, done

    def step(self, state: EnvState, action, poke=None):
        """One 60 Hz control step of every env; fallen envs auto-reset.
        `poke` = (do, part, theta) replaces the generator's draw.
        Returns (obs, state, reward, done)."""
        batch = action.shape[0]
        if poke is None:
            poke = self.draw_poke(state.generator, batch)
        smoothed = state.last_action + ACTION_SMOOTHING * (
            action - state.last_action)
        bodies = self.apply_poke(state.bodies, *poke)
        if self._fused_step is not None:
            bodies, obs, reward, done = self._fused_step(bodies, smoothed)
        else:
            bodies, obs, reward, done = self._step_core(bodies, smoothed)
        smoothed = torch.where(done[:, None], torch.zeros_like(smoothed),
                               smoothed)
        state = replace(state, bodies=bodies, last_action=smoothed,
                        steps=torch.where(done, torch.zeros_like(state.steps),
                                          state.steps + 1))
        return obs, state, reward, done


def make_vec_env(env: LocoEnv, batch_size: int):
    """(reset(generator), step(state, actions)) over `batch_size` envs."""

    def reset(generator: torch.Generator):
        return env.reset(batch_size, generator)

    def step(env_state: EnvState, actions):
        return env.step(env_state, actions)

    return reset, step
