"""Actor-critic policy (counterpart of
``d3d12renderer_tpu/learning/networks.py``).

Separate policy and value towers, each 2x128 tanh, a linear action head and
a state-independent log-std.  Layer names match the flax module's, so
`convert.actor_critic_from_flax` maps parameters one to one.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

HIDDEN = 128


def _lecun_normal_(weight, generator):
    """flax's default Dense kernel init: truncated normal, variance 1/fan_in
    (the 0.8796 factor undoes the truncation at two standard deviations)."""
    std = math.sqrt(1.0 / weight.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


class ActorCritic(nn.Module):
    """`forward(obs) -> (mean, log_std, value)` for obs (..., obs_dim)."""

    def __init__(self, obs_dim: int, action_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pi_0 = nn.Linear(obs_dim, HIDDEN)
        self.pi_1 = nn.Linear(HIDDEN, HIDDEN)
        self.action_head = nn.Linear(HIDDEN, action_dim)
        self.vf_0 = nn.Linear(obs_dim, HIDDEN)
        self.vf_1 = nn.Linear(HIDDEN, HIDDEN)
        self.value_head = nn.Linear(HIDDEN, 1)
        self.log_std = nn.Parameter(torch.zeros(action_dim))
        with torch.no_grad():
            for layer in (self.pi_0, self.pi_1, self.vf_0, self.vf_1,
                          self.value_head):
                _lecun_normal_(layer.weight, generator)
                layer.bias.zero_()
            # Action head U[0, 0.01), as flax's uniform(scale=0.01).
            self.action_head.weight.uniform_(0.0, 0.01, generator=generator)
            self.action_head.bias.zero_()

    def forward(self, obs):
        pi = torch.tanh(self.pi_1(torch.tanh(self.pi_0(obs))))
        mean = self.action_head(pi)
        vf = torch.tanh(self.vf_1(torch.tanh(self.vf_0(obs))))
        value = self.value_head(vf)[..., 0]
        return mean, self.log_std, value


def sample_action(mean, log_std, generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None):
    """(action, logp): mean + exp(log_std) * noise, with `noise` standard
    normal of mean's shape, drawn from `generator` unless given."""
    std = torch.exp(log_std)
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator,
                            device=mean.device, dtype=mean.dtype)
    action = mean + std * noise
    return action, gaussian_logp(action, mean, log_std)


def gaussian_logp(action, mean, log_std):
    std = torch.exp(log_std)
    z = (action - mean) / std
    return torch.sum(-0.5 * z * z - log_std - 0.5 * math.log(2.0 * math.pi),
                     dim=-1)


def gaussian_entropy(log_std):
    return torch.sum(log_std + 0.5 * math.log(2.0 * math.pi * math.e), dim=-1)
