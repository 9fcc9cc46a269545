"""Random-policy rollout of the batched ragdoll locomotion env on the port
(`d3d12renderer_tpu_torch.learning.loco_env`; counterpart of
examples/loco_rollout.py).  On the card every env step is one launch of
the fused whole-substep kernel.  Runs on the card by default; `--device cpu`
runs on the CPU.

Usage: python examples/torch_loco_rollout.py [--batch 16] [--steps 120]
                                             [--device cuda|cpu]
"""

import argparse
import os
import sys
import time

# Allow `python examples/x.py` without installing the package (the repo
# root is the import root).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--steps", type=int, default=120)
    parser.add_argument("--device", default="cuda")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from d3d12renderer_tpu_torch.cuda_build import resolve_device
    from d3d12renderer_tpu_torch.learning.loco_env import (ACTION_SIZE,
                                                           LocoEnv,
                                                           make_vec_env)

    device = resolve_device(args.device)
    env = LocoEnv(device=device)
    reset, step = make_vec_env(env, args.batch)
    obs, st = reset(torch.Generator(device=device).manual_seed(0))
    actions_gen = torch.Generator(device=device).manual_seed(1)

    t0 = time.perf_counter()
    rewards, dones = [], torch.zeros((), dtype=torch.int64, device=device)
    with torch.inference_mode():
        for _ in range(args.steps):
            actions = 0.3 * torch.randn((args.batch, ACTION_SIZE),
                                        generator=actions_gen, device=device)
            obs, st, r, d = step(st, actions)
            rewards.append(r.mean())
            dones += d.sum()
    rewards = torch.stack(rewards).tolist()
    dt = time.perf_counter() - t0
    finite = bool(torch.isfinite(obs).all())

    print(f"{args.steps} steps x {args.batch} envs in {dt:.2f}s "
          f"({args.steps * args.batch / dt:,.0f} env-steps/s incl. the "
          f"kernels' build) on {device}")
    print(f"mean reward: {sum(rewards) / len(rewards):.3f}  first/last: "
          f"{rewards[0]:.3f}/{rewards[-1]:.3f}  episode terminations: "
          f"{int(dones)}")
    print(f"obs finite: {finite}")
    return {"rewards": rewards, "terminations": int(dones),
            "obs_finite": finite, "seconds": dt}


if __name__ == "__main__":
    main()
