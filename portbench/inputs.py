"""Inputs the benchmark makes from `--seed` and hands to the program and
the reference alike."""

from __future__ import annotations

import math
import random


def policy_weights(config: dict, seed: int, device):
    """The actor-critic's parameters by name (two tanh towers of
    `config["policy"]["hidden"]`, an action head, a value head and a
    log-std), from one generator on `device` in one draw: weights normal
    with variance 1/fan_in, the action head's scaled by `head_scale`,
    biases and the log-std small."""
    import torch

    obs, act = config["obs"], config["action"]
    policy = config["policy"]
    h0, h1 = policy["hidden"]
    shapes = {}
    for tower in ("pi", "vf"):
        shapes[f"{tower}_0.weight"] = (h0, obs)
        shapes[f"{tower}_0.bias"] = (h0,)
        shapes[f"{tower}_1.weight"] = (h1, h0)
        shapes[f"{tower}_1.bias"] = (h1,)
    shapes["action_head.weight"] = (act, h1)
    shapes["action_head.bias"] = (act,)
    shapes["value_head.weight"] = (1, h1)
    shapes["value_head.bias"] = (1,)
    shapes["log_std"] = (act,)
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, base = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        x = flat[base:base + n].view(shape)
        base += n
        if name == "log_std":
            x = x * policy["log_std_scale"] + policy["log_std_mean"]
        elif name.endswith("bias"):
            x = x * policy["bias_scale"]
        else:
            x = x / math.sqrt(shape[1])
            if name.startswith("action_head"):
                x = x * policy["head_scale"]
        out[name] = x.contiguous()
    return out


def checked_calls(seed: int, traffic: dict):
    """The calls whose answers are checked: `checked_calls` of the calls
    `check_from` .. `check_to` - 1, drawn from the seed."""
    rng = random.Random(seed)
    return sorted(rng.sample(range(traffic["check_from"], traffic["check_to"]),
                             traffic["checked_calls"]))
