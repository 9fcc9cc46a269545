"""Carry weights and states between the JAX package and the port through
numpy (neither side's tensors cross over)."""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .learning.loco_env import EnvState
from .learning.networks import ActorCritic
from .physics.types import BodyState, SceneArchetype

_DENSE = ("pi_0", "pi_1", "action_head", "vf_0", "vf_1", "value_head")
_BODY_FIELDS = ("pos", "rot", "vel", "omega", "force", "torque")


def actor_critic_from_flax(params_np: Mapping, device="cpu") -> ActorCritic:
    """Build the port's ActorCritic from flax `ActorCritic` parameters as
    numpy arrays (`{"params": {...}}` or the inner dict).  flax Dense kernels
    are (in, out); torch Linear weights are (out, in)."""
    p = params_np.get("params", params_np)
    obs_dim = np.asarray(p["pi_0"]["kernel"]).shape[0]
    action_dim = np.asarray(p["log_std"]).shape[0]
    model = ActorCritic(obs_dim, action_dim)
    with torch.no_grad():
        for name in _DENSE:
            layer = getattr(model, name)
            layer.weight.copy_(torch.as_tensor(
                np.asarray(p[name]["kernel"], np.float32).T))
            layer.bias.copy_(torch.as_tensor(
                np.asarray(p[name]["bias"], np.float32)))
        model.log_std.copy_(torch.as_tensor(
            np.asarray(p["log_std"], np.float32)))
    return model.to(device)


def body_state_from_numpy(src, device="cpu") -> BodyState:
    """BodyState from any object or mapping with (B, N, k) numpy-convertible
    pos / rot / vel / omega / force / torque."""
    def get(name):
        x = src[name] if isinstance(src, Mapping) else getattr(src, name)
        return torch.as_tensor(np.array(x, np.float32), device=device)

    return BodyState(*(get(f) for f in _BODY_FIELDS))


def env_state_from_numpy(bodies, last_action, steps,
                         generator: torch.Generator, device="cpu") -> EnvState:
    return EnvState(
        bodies=body_state_from_numpy(bodies, device),
        last_action=torch.as_tensor(np.array(last_action, np.float32),
                                    device=device),
        generator=generator,
        steps=torch.as_tensor(np.array(steps, np.int32), device=device))


def archetype_to_numpy(arch) -> Dict[str, np.ndarray]:
    """Flatten an archetype (the port's, or the JAX package's) into named
    numpy arrays over the fields the port has, for field-by-field
    comparison.  Ints come out as int64."""
    out: Dict[str, np.ndarray] = {}

    def put(name, x):
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        out[name] = x.astype(np.int64) if x.dtype.kind in "iu" else x

    for f in SceneArchetype.__dataclass_fields__:
        if f in ("joints", "contact_color_indices", "joint_color_indices",
                 "cache", "vs_plane_segments") or f.startswith("num_") \
                or f == "vs_plane_num_colors":
            continue
        put(f, getattr(arch, f))
    for i, idx in enumerate(arch.contact_color_indices):
        put(f"contact_color_{i}", idx)
    for k, table in enumerate(arch.joints):
        for f in ("body_a", "body_b", "color", "valid"):
            put(f"joint_{table.kind}_{f}", getattr(table, f))
        for name, v in table.params.items():
            put(f"joint_{table.kind}_param_{name}", v)
        for i, idx in enumerate(arch.joint_color_indices[k]):
            put(f"joint_{table.kind}_color_{i}", idx)
    for f in ("num_bodies", "num_colliders", "num_planes",
              "vs_plane_num_colors"):
        put(f, getattr(arch, f))
    put("vs_plane_segments", np.asarray(arch.vs_plane_segments, np.int64))
    return out
