"""The port's main path (counterpart of ``__graft_entry__.entry``): a policy
forward plus one batched ragdoll locomotion env step."""

from __future__ import annotations

import torch

from .learning.loco_env import ACTION_SIZE, FRAME_RATE, STATE_SIZE, LocoEnv
from .learning.networks import ActorCritic
from .physics.types import PhysicsSettings


def entry(device="cpu", batch: int = 8, seed: int = 0,
          fused_substep: str = "auto", solver_backend: str = "auto"):
    """Returns `(fn, (model, env_state, obs))` on `device`, where
    `fn(model, env_state, obs) -> (obs, env_state, reward, done)` runs the
    policy and steps every env with its mean action.  Weights and pokes come
    from torch Generators seeded with `seed + 1` and `seed`.  With the
    defaults (the JAX env's settings) the env step on a CUDA device is one
    fused-kernel launch; `fused_substep="off"` takes the unfused step with
    the colored-solver kernel, and `solver_backend="plain"` its plain
    PyTorch version."""
    device = torch.device(device)
    env = LocoEnv(settings=PhysicsSettings(
        frame_rate=FRAME_RATE, fused_substep=fused_substep,
        solver_backend=solver_backend), device=device)
    obs, env_state = env.reset(
        batch, torch.Generator(device=device).manual_seed(seed))
    model = ActorCritic(STATE_SIZE, ACTION_SIZE,
                        generator=torch.Generator().manual_seed(seed + 1))
    model = model.to(device).eval()

    @torch.inference_mode()
    def fn(model, env_state, obs):
        mean, _, _ = model(obs)
        return env.step(env_state, mean)

    return fn, (model, env_state, obs)
