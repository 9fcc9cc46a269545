"""The rollout's check: the env step of every env, recomputed by the plain
reference from the program's state before the step, against the program's
answer.  The reference imports nothing of the program."""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager

import torch

from . import policy
from .frozen.learning.loco_env import LocoEnv
from .frozen.physics.types import BodyState

BODY_FIELDS = ("pos", "rot", "vel", "omega", "force", "torque")
# `done` (head height under 1 m) may differ only where the reference's
# height is this close to 1 m (the limit of `pose_gap`); such envs are left
# out of every gap.
DONE_BAND = 1e-3
GAPS = ("obs_gap", "reward_gap", "vel_gap", "omega_gap", "pose_gap",
        "done_flips")


def _cast(x, dtype):
    if isinstance(x, torch.Tensor):
        return x.to(dtype) if x.is_floating_point() else x
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _cast(getattr(x, f.name), dtype)
            for f in dataclasses.fields(x) if f.init})
    if type(x) in (list, tuple):
        return type(x)(_cast(v, dtype) for v in x)
    if isinstance(x, dict):
        return {k: _cast(v, dtype) for k, v in x.items()}
    return x


_ENV_TENSORS = ("arch", "_state0", "target_points", "target_velocities",
                "target_local_rot", "_obs0", "local_points",
                "torso_velocity_target", "_poke_offset")


class GraphStep:
    """`env.step(bodies, last_action, action, poke)` at one batch size,
    replayed from a CUDA graph: the plain step launches some ten thousand
    small kernels, which the host alone would take about a second to
    dispatch.  The same kernels run as in the eager step."""

    def __init__(self, env: LocoEnv, bodies, last_action, action, poke):
        self.env = env
        self.inputs = ([getattr(bodies, f).clone() for f in BODY_FIELDS],
                       last_action.clone(), action.clone(),
                       [x.clone() for x in poke])
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                self._step()
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.outputs = self._step()

    def _step(self):
        fields, last_action, action, poke = self.inputs
        obs, bodies, smoothed, reward, done, head_y = self.env.step(
            BodyState(*fields), last_action, action, tuple(poke))
        return (obs, [getattr(bodies, f) for f in BODY_FIELDS], smoothed,
                reward, done, head_y, self.env.active_points)

    def __call__(self, bodies, last_action, action, poke):
        fields, la, act, pk = self.inputs
        for dst, f in zip(fields, BODY_FIELDS):
            dst.copy_(getattr(bodies, f))
        la.copy_(last_action)
        act.copy_(action)
        for dst, x in zip(pk, poke):
            dst.copy_(x)
        self.graph.replay()
        obs, out, smoothed, reward, done, head_y, points = self.outputs
        return (obs.clone(), BodyState(*(x.clone() for x in out)),
                smoothed.clone(), reward.clone(), done.clone(), head_y.clone(),
                points.clone())


class Reference:
    """The plain env step on `device`, in float32 or, for the control, in
    `dtype` (every tensor of the env and the step in that type).  On a
    card, the float32 step is replayed from a CUDA graph."""

    def __init__(self, device, dtype=torch.float32):
        self.env = LocoEnv(device=device)
        self.dtype = dtype
        self._lowered = dtype != torch.float32
        self._graph = None

    def env_step(self, bodies, last_action, action, poke):
        """(obs, bodies, smoothed, reward, done, head height, points)."""
        if self._lowered or not bodies.pos.is_cuda:
            out = self.env.step(bodies, last_action, action, poke)
            return out + (self.env.active_points,)
        if self._graph is None:
            self._graph = GraphStep(self.env, bodies, last_action, action,
                                    poke)
        return self._graph(bodies, last_action, action, poke)

    @contextmanager
    def _precision(self):
        if not self._lowered:
            yield
            return
        old = torch.get_default_dtype()
        torch.set_default_dtype(self.dtype)
        try:
            yield
        finally:
            torch.set_default_dtype(old)

    def _lower(self):
        """Cast the env's tensors once, after a float32 step has built its
        colour plans (integer tables, kept)."""
        for name in _ENV_TENSORS:
            setattr(self.env, name, _cast(getattr(self.env, name),
                                          self.dtype))
        self._lowered_ready = True

    def step(self, weights, before, generator_state):
        """The reference's answer to one env step: `before` holds the
        program's state before it (`bodies` fields, `last_action`, `obs`)
        and `generator_state` its poke generator's state.  Returns a dict
        of obs, reward, done, the bodies after, the head's height before
        the reset and the active contact points."""
        dev = before["obs"].device
        g = torch.Generator(device=dev)
        g.set_state(generator_state)
        batch = before["obs"].shape[0]
        poke = self.env.draw_poke(g, batch)
        bodies = BodyState(*(before[f] for f in BODY_FIELDS))
        last_action, obs = before["last_action"], before["obs"]
        if self._lowered and not getattr(self, "_lowered_ready", False):
            self.env.step(bodies, last_action,
                          policy.forward(weights, obs)[0], poke)
            self._lower()
        if self._lowered:
            weights = _cast(weights, self.dtype)
            bodies = _cast(bodies, self.dtype)
            last_action, obs = (x.to(self.dtype) for x in (last_action, obs))
        with torch.no_grad(), self._precision():
            action = policy.forward(weights, obs)[0]
            obs2, bodies2, _, reward, done, head_y, points = self.env_step(
                bodies, last_action, action, poke)
        out = {"obs": obs2, "reward": reward, "done": done, "head_y": head_y,
               "points": float(points)}
        out.update({f: getattr(bodies2, f) for f in ("pos", "rot", "vel",
                                                      "omega")})
        return {k: (v.float() if isinstance(v, torch.Tensor)
                    and v.is_floating_point() else v) for k, v in out.items()}


def start_gaps(env: LocoEnv, start: dict) -> dict:
    """The widest gaps between the program's initial state (pos, rot, vel,
    omega, obs of every env) and the reference's standing pose."""
    s0 = env._state0
    pose = max(float((start[f] - getattr(s0, f)).abs().max())
               for f in ("pos", "rot", "vel", "omega"))
    return {"pose_gap": pose,
            "obs_gap": float((start["obs"] - env._obs0).abs().max())}


def gaps(answer: dict, ref: dict) -> dict:
    """The widest gaps between an answer and the reference's, over the envs
    whose fall check is not on the edge, and the count of envs whose
    `done` differs off the edge."""
    edge = (ref["head_y"] - 1.0).abs() < DONE_BAND
    keep = ~edge

    def widest(a, b):
        d = (a.float() - b.float()).abs()
        d = torch.where(torch.isfinite(d), d, torch.full_like(d, float("inf")))
        d = d.reshape(d.shape[0], -1)[keep]
        return float(d.max()) if d.numel() else 0.0

    return {
        "obs_gap": widest(answer["obs"], ref["obs"]),
        "reward_gap": widest(answer["reward"][:, None], ref["reward"][:, None]),
        "vel_gap": widest(answer["vel"], ref["vel"]),
        "omega_gap": widest(answer["omega"], ref["omega"]),
        "pose_gap": max(widest(answer["pos"], ref["pos"]),
                        widest(answer["rot"], ref["rot"])),
        "done_flips": int(((answer["done"] != ref["done"]) & keep).sum()),
    }
