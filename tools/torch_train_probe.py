"""Where the host time of the port's PPO iteration goes, on one GPU, at
BASELINE config 5 (4096 envs, minibatches of 16,384 samples):

* whether building a small tensor from a Python list on the card waits for
  the card's queue (the env step's poke offset does it once per step): the
  host time of `torch.tensor([0.0, 0.2, 0.0], device="cuda")` behind ~50 ms
  of queued work, against an empty queue;
* the env step's wall time (host clock over STEPS steps, synchronised at
  the end) as it is and with that offset built once (`apply_poke`
  replaced), in turns;
* one minibatch update split into the loss forward, the backward
  (`torch.autograd.grad`) and `ppo.clip_and_adam`: host time per call (no
  synchronisation inside) and kernels per call (profiler).

    python3 tools/torch_train_probe.py

Every measurement is one JSON line on stdout with the card's name and
power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

STEPS = 50
REPS = 20


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import torch
    from torch.autograd import DeviceType

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this probe runs only on a GPU")
    from d3d12renderer_tpu_torch.core import maths as m
    from d3d12renderer_tpu_torch.entry import train_entry
    from d3d12renderer_tpu_torch.learning import ppo
    from d3d12renderer_tpu_torch.learning.loco_env import (
        ACTION_SIZE, POKE_STRENGTH, LocoEnv)

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]

    def emit(**kw):
        print(json.dumps({"card": card, **kw}), flush=True)

    # 1. A 3-float tensor from a Python list, behind queued work.
    a = torch.rand(4096, 4096, device=dev)
    for queued in (False, True):
        sync()
        if queued:
            for _ in range(40):
                a = torch.tanh(a @ a * 1e-3)
        t0 = time.perf_counter()
        torch.tensor([0.0, 0.2, 0.0], device=dev)
        host_ms = 1e3 * (time.perf_counter() - t0)
        emit(probe="torch.tensor(list) on the card", queued_work=queued,
             host_ms=host_ms)
        sync()

    # 2. The env step as it is, and with the poke offset built once.
    env = LocoEnv(device=dev)
    offset = torch.tensor([0.0, 0.2, 0.0], device=dev)
    stock = env.apply_poke

    def apply_poke_cached(bodies, do, part, theta):
        batch = do.shape[0]
        direction = torch.stack(
            [torch.cos(theta), torch.zeros_like(theta), torch.sin(theta)], -1)
        body = env.part_idx[part]
        envs = torch.arange(batch, device=dev)
        bpos = bodies.pos[envs, body]
        force = direction * POKE_STRENGTH * do[:, None]
        torque = m.cross(bpos + offset - bpos, force)
        f, t = bodies.force.clone(), bodies.torque.clone()
        f[envs, body] += force
        t[envs, body] += torque
        return bodies.replace(force=f, torque=t)

    action = torch.zeros((4096, ACTION_SIZE), device=dev)
    _, st = env.reset(4096, torch.Generator(device=dev).manual_seed(0))
    for label in ("as is", "offset once", "offset once", "as is"):
        env.apply_poke = stock if label == "as is" else apply_poke_cached
        with torch.no_grad():
            env.step(st, action)
            sync()
            t0 = time.perf_counter()
            for _ in range(STEPS):
                _, st, _, _ = env.step(st, action)
            sync()
        emit(probe="env step", apply_poke=label,
             step_ms=1e3 * (time.perf_counter() - t0) / STEPS)
    env.apply_poke = stock

    # 3. One minibatch update, split.
    train_iteration, state = train_entry(device=dev)
    state, _ = train_iteration(state)
    _, _, policy_apply = ppo.make_ppo(env, ppo.PPOConfig(num_envs=4096,
                                                         rollout_steps=32,
                                                         epochs=4))
    n, mb = 4096 * 32, 4096 * 32 // 8
    g = torch.Generator(device=dev).manual_seed(1)
    obs = torch.randn((mb, state.last_obs.shape[1]), generator=g, device=dev)
    act = torch.randn((mb, ACTION_SIZE), generator=g, device=dev)
    batch = ppo.Transition(obs, act, torch.randn(mb, generator=g, device=dev)
                           - 40.0, None, None, None)
    adv, ret = (torch.randn(mb, generator=g, device=dev) for _ in range(2))
    config = ppo.PPOConfig(num_envs=4096, rollout_steps=32, epochs=4)
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in state.params.items()}
    total, _ = ppo.ppo_loss(policy_apply, leaves, batch, adv, ret, config)
    grads = dict(zip(leaves, torch.autograd.grad(total,
                                                 list(leaves.values()))))
    parts = {
        "forward": lambda: ppo.ppo_loss(policy_apply, leaves, batch, adv,
                                        ret, config),
        "forward + backward": lambda: torch.autograd.grad(
            ppo.ppo_loss(policy_apply, leaves, batch, adv, ret, config)[0],
            list(leaves.values())),
        "clip_and_adam": lambda: ppo.clip_and_adam(
            state.params, grads, state.opt_state, config),
        "gather of the 8 fields (one epoch)": lambda: [
            x[torch.randperm(n, device=dev)] for x in fields],
    }
    fields = [torch.zeros((n, k), device=dev)
              for k in (66, 27, 1, 1, 1, 1, 1, 1)]
    for name, fn in parts.items():
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        host_ms = 1e3 * (time.perf_counter() - t0) / REPS
        sync()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        emit(probe="minibatch update", part=name, host_ms=host_ms,
             kernels=len(kernels),
             device_ms=sum(e.time_range.elapsed_us() for e in kernels) / 1e3)


if __name__ == "__main__":
    main()
