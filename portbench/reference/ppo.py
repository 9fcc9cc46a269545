"""PPO's reference: the first training iterations followed from the same
start and the same random numbers as the program, plain float32: the
rollout (the policy's sampled action and the plain env step), GAE, and the
clipped-objective minibatch updates with optax's `chain(clip_by_global_norm,
adam)` written out.  Imports nothing of the program."""

from __future__ import annotations

import math

import torch

from . import policy
from .frozen.physics.types import BodyState
from .loco import BODY_FIELDS, Reference, _cast

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def gaussian_logp(action, mean, log_std):
    z = (action - mean) / torch.exp(log_std)
    return torch.sum(-0.5 * z * z - log_std - 0.5 * math.log(2.0 * math.pi),
                     dim=-1)


def compute_gae(reward, value, done, last_value, gamma, lam):
    not_done = 1.0 - done.to(value.dtype)
    adv = torch.empty_like(value)
    gae = torch.zeros_like(last_value)
    next_value = last_value
    for t in range(value.shape[0] - 1, -1, -1):
        delta = reward[t] + gamma * next_value * not_done[t] - value[t]
        gae = delta + gamma * lam * not_done[t] * gae
        adv[t] = gae
        next_value = value[t]
    return adv, adv + value


def loss(params, obs, action, logp_old, adv, ret, ppo):
    """(total, pg_loss, vf_loss) of one minibatch."""
    mean, value = policy.forward(params, obs)
    logp = gaussian_logp(action, mean, params["log_std"])
    ratio = torch.exp(logp - logp_old)
    a_mean = adv.mean()
    a_std = torch.sqrt(torch.clamp(((adv - a_mean) ** 2).mean(), min=1e-16))
    a = (adv - a_mean) / (a_std + 1e-8)
    pg = -torch.minimum(ratio * a, torch.clamp(
        ratio, 1 - ppo["clip_eps"], 1 + ppo["clip_eps"]) * a).mean()
    vf = 0.5 * ((value - ret) ** 2).mean()
    return pg + ppo["vf_coef"] * vf, pg, vf


def clip_and_adam(params, grads, mu, nu, count, ppo):
    """One step of the global-norm clip, Adam and the learning rate."""
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    scale = torch.where(g_norm < ppo["max_grad_norm"],
                        torch.ones_like(g_norm), ppo["max_grad_norm"] / g_norm)
    count = count + 1
    new_p, new_mu, new_nu = {}, {}, {}
    for k in params:
        g = grads[k] * scale
        new_mu[k] = (1 - ADAM_B1) * g + ADAM_B1 * mu[k]
        new_nu[k] = (1 - ADAM_B2) * (g * g) + ADAM_B2 * nu[k]
        u = (new_mu[k] / (1 - ADAM_B1 ** count)) / (
            torch.sqrt(new_nu[k] / (1 - ADAM_B2 ** count)) + ADAM_EPS)
        new_p[k] = params[k] - ppo["learning_rate"] * u
    return new_p, new_mu, new_nu, count


FAULTS = ("half_batch", "reward")


def follow(config: dict, weights: dict, draws, device, dtype=torch.float32,
           fault=None):
    """The first len(draws) iterations from the standing start.  `draws`:
    per iteration (noise (T, B, A), pokes [(do, part, theta)] * T, perms
    (epochs, T B)).  Returns per iteration a dict of the mean pg_loss and
    vf_loss over its minibatches, the parameters and Adam's first moment
    after it, and the mean active contact points per env step.  `fault`
    plants one of FAULTS: each minibatch's loss over its first half only,
    or every reward scaled by 1.1 where it is produced."""
    if fault not in (None,) + FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    ppo = config["ppo"]
    envs = config["envs"]
    ref = Reference(device, dtype)
    env = ref.env
    s0 = env._state0
    bodies = BodyState(*(getattr(s0, f).expand((envs,) + getattr(s0, f).shape[1:])
                         .clone() for f in BODY_FIELDS))
    last_action = torch.zeros((envs, config["action"]), device=device)
    obs = env._obs0.expand(envs, -1).clone()
    params = {k: v.clone() for k, v in weights.items()}
    if dtype != torch.float32:
        # A float32 step first builds the env's tables; then everything
        # is cast.
        ref.env_step(bodies, last_action, last_action, draws[0][1][0])
        ref._lower()
        params = _cast(params, dtype)
        bodies = _cast(bodies, dtype)
        last_action, obs = last_action.to(dtype), obs.to(dtype)
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    count = 0
    out = []
    old = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        for noise, pokes, perms in draws:
            steps, points = [], 0.0
            with torch.no_grad():
                for t in range(noise.shape[0]):
                    mean, value = policy.forward(params, obs)
                    log_std = params["log_std"]
                    action = mean + torch.exp(log_std) * noise[t].to(dtype)
                    logp = gaussian_logp(action, mean, log_std)
                    obs2, bodies, last_action, reward, done, _, pts = \
                        ref.env_step(bodies, last_action, action, pokes[t])
                    points += float(pts)
                    if fault == "reward":
                        reward = reward * 1.1
                    steps.append((obs, action, logp, value, reward.to(dtype),
                                  done))
                    obs = obs2
                last_value = policy.forward(params, obs)[1]
            o, a, lp, v, r, d = (torch.stack(x) for x in zip(*steps))
            adv, ret = compute_gae(r, v, d, last_value, ppo["gamma"],
                                   ppo["gae_lambda"])
            n = o.shape[0] * o.shape[1]
            flat = [x.reshape((n,) + x.shape[2:]) for x in (o, a, lp, adv, ret)]
            pgs, vfs = [], []
            for e in range(ppo["epochs"]):
                mbs = [x[perms[e]].reshape((ppo["minibatches"], -1)
                                           + x.shape[1:]) for x in flat]
                for i in range(ppo["minibatches"]):
                    leaves = {k: p.detach().requires_grad_(True)
                              for k, p in params.items()}
                    batch = [x[i] for x in mbs]
                    if fault == "half_batch":
                        batch = [x[:x.shape[0] // 2] for x in batch]
                    total, pg, vf = loss(leaves, *batch, ppo)
                    grads = dict(zip(leaves, torch.autograd.grad(
                        total, list(leaves.values()))))
                    params, mu, nu, count = clip_and_adam(
                        {k: p.detach() for k, p in leaves.items()}, grads, mu,
                        nu, count, ppo)
                    pgs.append(pg.detach())
                    vfs.append(vf.detach())
            out.append({"pg_loss": float(torch.stack(pgs).mean()),
                        "vf_loss": float(torch.stack(vfs).mean()),
                        "params": {k: p.float() for k, p in params.items()},
                        "mu": {k: x.float() for k, x in mu.items()},
                        "points": points / noise.shape[0]})
    finally:
        torch.set_default_dtype(old)
    return out


def leaf_gap(program: dict, ref: dict, weight: dict, keep) -> float:
    """The widest gap, over the leaves in `keep`, between the program's and
    the reference's norm of a leaf (of `program[k] - weight[k]` where
    `weight` is given), measured against the larger of the reference
    leaf's norm and the median leaf's."""
    def norms(tree):
        return {k: float(torch.linalg.norm(
            (tree[k] - weight[k]) if weight is not None else tree[k]))
            for k in keep}

    p, r = norms(program), norms(ref)
    if not r:
        return 0.0
    median = sorted(r.values())[len(r) // 2]
    return max(abs(p[k] - r[k]) / max(r[k], median, 1e-30) for k in keep)


def moved_leaves(first_mu: dict) -> list:
    """The leaves whose first moment after the first iteration is not
    nought to rounding: its norm at least a thousandth of the median
    leaf's."""
    n = {k: float(torch.linalg.norm(v)) for k, v in first_mu.items()}
    median = sorted(n.values())[len(n) // 2]
    return [k for k, v in n.items() if v >= 1e-3 * median]
