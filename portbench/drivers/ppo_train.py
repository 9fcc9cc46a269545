"""PPO training: whole iterations of `entry.train_entry()`'s
`train_iteration` (rollout, GAE, the minibatch updates) called back to back.
Set-up builds the training state once, gives it the benchmark's weights,
and drives it through its first iterations with the benchmark's random
numbers (action noise, pokes, permutations), keeping the losses, Adam's
first moment after the first and the parameters after the last; the same
state then runs the window.  After the window the plain reference follows
those first iterations from the same start and numbers."""

from __future__ import annotations

import math
from collections import namedtuple

from ..inputs import policy_weights

# `train_iteration`'s `draws` argument: the fields it reads.
Draws = namedtuple("Draws", "noise pokes perms")


def make_draws(config: dict, seed: int, device, iterations: int):
    """Per iteration: noise (T, B, A) standard normal, T pokes (do, part,
    theta) of (B,) at the configuration's poke probability, `epochs`
    permutations of the T B samples; one generator on `device`."""
    import torch

    ppo, envs = config["ppo"], config["envs"]
    steps = ppo["rollout_steps"]
    gen = torch.Generator(device=device).manual_seed(seed ^ 0x5851F42D)
    out = []
    for _ in range(iterations):
        noise = torch.randn((steps, envs, config["action"]), generator=gen,
                            device=device)
        u = torch.rand((steps, 2, envs), generator=gen, device=device)
        part = torch.randint(0, config["bodies"], (steps, envs),
                             generator=gen, device=device)
        pokes = [(u[t, 0] < config["poke"]["probability"], part[t],
                  u[t, 1] * (2.0 * math.pi)) for t in range(steps)]
        perms = torch.stack([torch.randperm(steps * envs, generator=gen,
                                            device=device)
                             for _ in range(ppo["epochs"])])
        out.append((noise, pokes, perms))
    return out


class Driver:
    def __init__(self, cell):
        self.cell = cell
        cfg = cell.config
        self.units_per_call = cfg["ppo"]["rollout_steps"] * cfg["envs"]
        self.spans = {"rollout": [], "gae": [], "update": [], "monitor": []}

    def setup(self):
        from d3d12renderer_tpu_torch import entry as port

        cell, cfg = self.cell, self.cell.config
        ppo = cfg["ppo"]
        self.train, state = port.train_entry(
            device=cell.device, envs=cfg["envs"], rollout=ppo["rollout_steps"],
            minibatches=ppo["minibatches"], epochs=ppo["epochs"],
            seed=cell.seed)
        self.weights = policy_weights(cfg, cell.seed, cell.device)
        state = state._replace(params={k: v.clone()
                                       for k, v in self.weights.items()})
        self.draws = make_draws(cfg, cell.seed, cell.device,
                                cell.traffic["followed_iterations"])
        self.followed = []
        for noise, pokes, perms in self.draws:
            state, metrics = self.train(state, draws=Draws(noise, pokes,
                                                           perms))
            self.followed.append({
                "pg_loss": float(metrics["pg_loss"]),
                "vf_loss": float(metrics["vf_loss"]),
                "params": {k: v.clone() for k, v in state.params.items()},
                "mu": {k: v.clone() for k, v in state.opt_state.mu.items()}})
        self.state = state

    def call(self, i: int, mode: str = "window"):
        phases = mode == "spans"
        self.state, metrics = self.train(self.state, profile_phases=phases)
        if phases:
            for name, ms in metrics["phase_ms"].items():
                self.spans[name].append(ms)

    def free(self):
        self.train = self.state = None

    def _gaps(self, program, ref):
        from ..reference import ppo as ppo_ref

        c = self.cell.config["ppo"]["vf_coef"]

        def total(x):
            return x["pg_loss"] + c * x["vf_loss"]

        keep = ppo_ref.moved_leaves(ref[0]["mu"])
        return {
            "loss_gap": max(abs(total(p) - total(r)) / max(abs(total(r)),
                                                            1e-30)
                            for p, r in zip(program, ref)),
            "mu_gap": ppo_ref.leaf_gap(program[0]["mu"], ref[0]["mu"], None,
                                       keep),
            "change_gap": ppo_ref.leaf_gap(program[-1]["params"],
                                           ref[-1]["params"], self.weights,
                                           keep),
        }

    def check(self, run):
        from ..reference import ppo as ppo_ref

        ref = ppo_ref.follow(self.cell.config, self.weights, self.draws,
                             self.cell.device)
        run.counts["contact_points"] = sum(r["points"] for r in ref) / len(ref)
        return self._gaps(self.followed, ref), len(ref)

    def fault(self, run, name):
        """The reference with a fault planted (`reference.ppo.FAULTS`) in
        the program's place, against the float32 reference."""
        import torch

        from ..reference import ppo as ppo_ref

        cfg, dev = self.cell.config, self.cell.device
        ref = ppo_ref.follow(cfg, self.weights, self.draws, dev, torch.float32)
        bad = ppo_ref.follow(cfg, self.weights, self.draws, dev, torch.float32,
                             fault=name)
        return self._gaps(bad, ref)

    def control(self, run, dtype):
        """The reference in `dtype` in the program's place, against the
        float32 reference."""
        import torch

        from ..reference import ppo as ppo_ref

        cfg, dev = self.cell.config, self.cell.device
        ref = ppo_ref.follow(cfg, self.weights, self.draws, dev, torch.float32)
        low = ppo_ref.follow(cfg, self.weights, self.draws, dev, dtype)
        return self._gaps(low, ref)
