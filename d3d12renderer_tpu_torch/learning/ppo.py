"""PPO on the batched locomotion env (counterpart of
``d3d12renderer_tpu/learning/ppo.py``): rollout, GAE and clipped-objective
minibatch updates, one training iteration per call.

The JAX package jits the whole iteration; here it runs eagerly on the env's
device.  At 4096 envs every rollout step is one policy forward and one
launch of the fused env-step kernel (`physics/substep_cuda.py`); the
gradients go through the MLP by autograd, outside any kernel, as the JAX
package leaves them to XLA.  The optimizer is optax's
`chain(clip_by_global_norm, adam)` written out (`clip_and_adam`).

Every random draw comes from a `torch.Generator` on the device: the action
noise and the epoch permutations from `TrainState.rng`, the pokes from the
env state's generator.  `train_iteration(state, draws=...)` takes any of
them as tensors instead (`Draws`), so that a test can replay JAX's.

With a process group (`make_ppo(..., group=)`, the counterpart of
`PPOConfig.axis_name`), the advantage statistics and the gradients are
averaged over the group's ranks (`all_mean`), so that every rank applies
the same update; `parallel/data_parallel.py` builds on it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
from torch.func import functional_call

from ..core import profiling
from .loco_env import ACTION_SIZE, STATE_SIZE, EnvState, LocoEnv
from .monitor import EpisodeStats, init_stats, update_stats
from .networks import (ActorCritic, gaussian_entropy, gaussian_logp,
                       sample_action)

# optax.adam's defaults (optax/_src/alias.py:415 `adam`).
ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8
ADAM_EPS_ROOT = 0.0


@dataclass(frozen=True)
class PPOConfig:
    num_envs: int = 64
    rollout_steps: int = 128
    minibatches: int = 8
    epochs: int = 10
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.1
    vf_coef: float = 0.5
    ent_coef: float = 0.0
    max_grad_norm: float = 0.5
    learning_rate: float = 2.5e-5


class AdamState(NamedTuple):
    """optax's `ScaleByAdamState`: the step count (int32) and the first and
    second moments, one tensor per parameter name."""

    count: torch.Tensor
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]   # ActorCritic's state_dict
    opt_state: AdamState
    env_state: EnvState
    last_obs: torch.Tensor
    rng: torch.Generator              # action noise and permutations
    stats: EpisodeStats


class Transition(NamedTuple):
    obs: torch.Tensor
    action: torch.Tensor
    logp: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor


class Draws(NamedTuple):
    """Random numbers of one iteration given instead of drawn; None draws.
    noise: (T, B, action) standard normal; pokes: T tuples (do, part,
    theta) of (B,); perms: (epochs, T B) permutations."""

    noise: Optional[torch.Tensor] = None
    pokes: Optional[Sequence] = None
    perms: Optional[torch.Tensor] = None


def compute_gae(traj: Transition, last_value, gamma: float, lam: float):
    """(advantages, returns), (T, B) each, by the reverse recursion."""
    not_done = 1.0 - traj.done.to(torch.float32)
    advantages = torch.empty_like(traj.value)
    gae = torch.zeros_like(last_value)
    next_value = last_value
    for t in range(traj.value.shape[0] - 1, -1, -1):
        delta = traj.reward[t] + gamma * next_value * not_done[t] - traj.value[t]
        gae = delta + gamma * lam * not_done[t] * gae
        advantages[t] = gae
        next_value = traj.value[t]
    return advantages, advantages + traj.value


def all_mean(x: torch.Tensor, group) -> torch.Tensor:
    """`jax.lax.pmean`: the sum of `x` over the group's ranks divided by the
    group's size (gloo has no AVG reduction).  A new tensor; `x` is left as
    it was."""
    x = x.detach().clone()
    dist.all_reduce(x, group=group)
    return x / dist.get_world_size(group)


def ppo_loss(policy_apply, params, batch: Transition, advantages, returns,
             config: PPOConfig, group=None):
    """(total, (pg_loss, vf_loss, entropy)) of one minibatch: the clipped
    surrogate with the minibatch's advantages normalised (their mean and
    variance averaged over `group`'s ranks when one is given), half the
    squared value error, the policy's entropy."""
    def group_mean(x):
        return x.mean() if group is None else all_mean(x.mean(), group)

    mean, log_std, value = policy_apply(params, batch.obs)
    logp = gaussian_logp(batch.action, mean, log_std)
    ratio = torch.exp(logp - batch.logp)
    adv_mean = group_mean(advantages)
    adv_std = torch.sqrt(torch.clamp(
        group_mean((advantages - adv_mean) ** 2), min=1e-16))
    adv = (advantages - adv_mean) / (adv_std + 1e-8)
    pg1 = ratio * adv
    pg2 = torch.clamp(ratio, 1 - config.clip_eps, 1 + config.clip_eps) * adv
    pg_loss = -torch.minimum(pg1, pg2).mean()
    vf_loss = 0.5 * ((value - returns) ** 2).mean()
    ent = gaussian_entropy(log_std).mean()
    total = pg_loss + config.vf_coef * vf_loss - config.ent_coef * ent
    return total, (pg_loss, vf_loss, ent)


def clip_and_adam(params, grads, state: AdamState, config: PPOConfig):
    """One step of optax 0.2.6's `chain(clip_by_global_norm(max_norm),
    adam(lr))` and `apply_updates`, in its operation order, over every
    parameter (log_std too).  Returns (params, state), both new.

    * clip (optax/transforms/_clipping.py:91-105): g_norm = sqrt(sum of
      g * g) over every parameter (optax/_src/linear_algebra.py:35-39); g
      where g_norm < max_norm, else (g / g_norm) * max_norm.
      (`clip_grad_norm_` scales by max_norm / (norm + 1e-6), another
      function.)
    * adam (optax/_src/transform.py:276-306): mu = (1 - b1) g + b1 mu, nu =
      (1 - b2) g^2 + b2 nu (optax/tree_utils/_tree_math.py:353-399), count
      + 1, then mu / (1 - b1^count) / (sqrt(nu / (1 - b2^count) + eps_root)
      + eps) (`tree_bias_correction`, :401-411).
    * the learning rate (optax/_src/transform.py:942-965, :467): u = -lr u;
      apply_updates (optax/_src/update.py): p + u.

    Every parameter's entries go through one flat buffer, so that the step
    is ~30 launches whatever the number of tensors; the new parameters and
    moments are views of it.  The clip's choice stays on the device (no
    host read)."""
    names = list(params)
    shapes = [params[k].shape for k in names]

    def flat(tree):
        return torch.cat([tree[k].reshape(-1) for k in names])

    def unflat(x):
        parts = torch.split(x, [s.numel() for s in shapes])
        return {k: p.view(s) for k, p, s in zip(names, parts, shapes)}

    g = flat(grads)
    g_norm = torch.sqrt(torch.sum(g * g))
    g = torch.where(g_norm < config.max_grad_norm, g,
                    (g / g_norm) * config.max_grad_norm)
    mu = (1 - ADAM_B1) * g + ADAM_B1 * flat(state.mu)
    nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * flat(state.nu)
    count = state.count + 1
    bc1 = 1 - torch.pow(torch.full((), ADAM_B1, device=g.device), count)
    bc2 = 1 - torch.pow(torch.full((), ADAM_B2, device=g.device), count)
    u = (mu / bc1) / (torch.sqrt(nu / bc2 + ADAM_EPS_ROOT) + ADAM_EPS)
    new = flat(params) + -config.learning_rate * u
    return unflat(new), AdamState(count, unflat(mu), unflat(nu))


def _all_mean_tensors(tensors, group):
    """`all_mean` of every tensor, through one flat buffer (one collective)."""
    flat = all_mean(torch.cat([t.reshape(-1) for t in tensors]), group)
    parts = torch.split(flat, [t.numel() for t in tensors])
    return [p.view(t.shape) for p, t in zip(parts, tensors)]


def make_ppo(env: LocoEnv, config: PPOConfig = PPOConfig(), group=None):
    """(init, train_iteration, policy_apply) on the env's device.

    * `init(seed=0) -> TrainState`: the env reset with a generator seeded
      `seed`, the policy's weights from a CPU generator seeded `seed + 1`,
      `rng` seeded `seed + 2`.
    * `train_iteration(state, draws=None, profile_phases=False) ->
      (state, metrics)`: one rollout of `rollout_steps` steps of every env,
      GAE, `epochs` passes of `minibatches` updates over a permutation of
      the T B samples, the episode monitor folded; metrics are 0-d device
      tensors, and with `profile_phases` `metrics["phase_ms"]` holds the
      rollout, GAE, update and monitor times (CUDA events on the card).
      The input state's tensors are not changed; its generators advance.
    * `policy_apply(params, obs) -> (mean, log_std, value)`.

    `group`: a `torch.distributed` process group whose ranks each run
    this iteration on their own envs; each minibatch's advantage mean and
    variance and its gradients are averaged over the ranks (JAX's
    `axis_name`).  None: this process alone."""
    device = env.device
    network = ActorCritic(STATE_SIZE, ACTION_SIZE).to(device)

    def policy_apply(params, obs):
        return functional_call(network, params, (obs,))

    def init(seed: int = 0) -> TrainState:
        obs, env_state = env.reset(
            config.num_envs, torch.Generator(device=device).manual_seed(seed))
        model = ActorCritic(STATE_SIZE, ACTION_SIZE,
                            generator=torch.Generator().manual_seed(seed + 1))
        params = {k: v.detach().to(device)
                  for k, v in model.state_dict().items()}
        opt_state = AdamState(
            torch.zeros((), dtype=torch.int32, device=device),
            {k: torch.zeros_like(v) for k, v in params.items()},
            {k: torch.zeros_like(v) for k, v in params.items()})
        return TrainState(params, opt_state, env_state, obs,
                          torch.Generator(device=device).manual_seed(seed + 2),
                          init_stats(config.num_envs, device))

    def rollout(state: TrainState, draws: Draws):
        params, env_state, obs = state.params, state.env_state, state.last_obs
        steps = []
        with torch.no_grad():
            for t in range(config.rollout_steps):
                mean, log_std, value = policy_apply(params, obs)
                action, logp = sample_action(
                    mean, log_std, state.rng,
                    noise=None if draws.noise is None else draws.noise[t])
                next_obs, env_state, reward, done = env.step(
                    env_state, action,
                    poke=None if draws.pokes is None else draws.pokes[t])
                steps.append((obs, action, logp, value, reward, done))
                obs = next_obs
            last_value = policy_apply(params, obs)[2]
        traj = Transition(*(torch.stack(x) for x in zip(*steps)))
        return traj, env_state, obs, last_value

    def train_iteration(state: TrainState, draws: Optional[Draws] = None,
                        profile_phases: bool = False):
        draws = draws or Draws()
        phase = profiling.Stages("ppo", profile_phases, device)
        with phase("rollout"):
            traj, env_state, last_obs, last_value = rollout(state, draws)
        with phase("gae"):
            advantages, returns = compute_gae(traj, last_value, config.gamma,
                                              config.gae_lambda)

        n = config.rollout_steps * config.num_envs
        with phase("update"):
            flat = [x.reshape((n,) + x.shape[2:])
                    for x in tuple(traj) + (advantages, returns)]
            params, opt_state = state.params, state.opt_state
            aux = []
            for e in range(config.epochs):
                perm = (draws.perms[e] if draws.perms is not None else
                        torch.randperm(n, generator=state.rng, device=device))
                mbs = [x[perm].reshape((config.minibatches, -1) + x.shape[1:])
                       for x in flat]
                for i in range(config.minibatches):
                    *batch, adv, ret = (x[i] for x in mbs)
                    leaves = {k: v.detach().requires_grad_(True)
                              for k, v in params.items()}
                    total, losses = ppo_loss(policy_apply, leaves,
                                             Transition(*batch), adv, ret,
                                             config, group)
                    grads = torch.autograd.grad(total, list(leaves.values()))
                    if group is not None:
                        grads = _all_mean_tensors(grads, group)
                    params, opt_state = clip_and_adam(
                        params, dict(zip(leaves, grads)), opt_state, config)
                    aux.append(torch.stack([x.detach() for x in losses]))

        with phase("monitor"):
            stats = state.stats
            for t in range(config.rollout_steps):
                stats = update_stats(stats, traj.reward[t], traj.done[t])

        pg_loss, vf_loss, ent = torch.stack(aux).mean(0)
        metrics = {
            "reward_mean": traj.reward.mean(),
            "episode_done_rate": traj.done.to(torch.float32).mean(),
            "pg_loss": pg_loss, "vf_loss": vf_loss, "entropy": ent,
            "value_mean": traj.value.mean(),
        }
        if profile_phases:
            metrics["phase_ms"] = phase.ms()
        return TrainState(params, opt_state, env_state, last_obs, state.rng,
                          stats), metrics

    return init, train_iteration, policy_apply
