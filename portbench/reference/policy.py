"""The policy's mean action and value, plain float32 (TF32 off)."""

from __future__ import annotations

import torch


def forward(weights, obs):
    """(mean (B, A), value (B,)) of the two-tower tanh actor-critic."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def dense(name, x):
        return x @ weights[f"{name}.weight"].t() + weights[f"{name}.bias"]

    pi = torch.tanh(dense("pi_1", torch.tanh(dense("pi_0", obs))))
    vf = torch.tanh(dense("vf_1", torch.tanh(dense("vf_0", obs))))
    return dense("action_head", pi), dense("value_head", vf)[..., 0]
