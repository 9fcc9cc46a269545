"""Train the ragdoll locomotion policy with PPO on the port (counterpart of
examples/train_locomotion.py): `learning.ppo.make_ppo`'s rollouts (one
fused-kernel launch per env step on the card) and updates, episode stats
to `episodes.csv` (`learning.monitor.MonitorCSV`) and checkpoints of the
policy (`utils.checkpoint.CheckpointManager`) under `--logdir`.
`--mesh N` trains data-parallel over N ranks of `torch.distributed`
(`parallel.data_parallel.make_distributed_ppo`, `--envs` envs on each
rank), launched by `torchrun --nproc-per-node N`; rank 0 writes the logs.
`--eval-render` path-traces env 0's final pose to a PNG.  Runs on the card
by default; `--device cpu` runs on the CPU.

Usage:
  python examples/torch_train_locomotion.py [--iterations 20] [--envs 128]
      [--rollout 64] [--device cuda|cpu] [--logdir build/examples/loco]
      [--eval-render build/examples/eval.png]
  torchrun --nproc-per-node 4 examples/torch_train_locomotion.py --mesh 4
"""

import argparse
import os
import statistics
import sys
import time

# Allow `python examples/x.py` without installing the package (the repo
# root is the import root).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "build", "examples")
# examples/train_locomotion.py:104-107: the eval render's view.
EVAL_EYE, EVAL_TARGET = (4.0, 2.5, 5.0), (0.0, 0.9, 0.0)
EVAL_SIZE, EVAL_SPP = 256, 8


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iterations", type=int, default=20)
    parser.add_argument("--envs", type=int, default=128)
    parser.add_argument("--rollout", type=int, default=64)
    parser.add_argument("--lr", type=float, default=None,
                        help="override the reference learning rate (2.5e-5)")
    parser.add_argument("--ent-coef", type=float, default=None)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--mesh", type=int, default=0,
                        help="data-parallel ranks (launch with torchrun)")
    parser.add_argument("--logdir", default=os.path.join(OUT_DIR, "loco"))
    parser.add_argument("--eval-render", default=None,
                        help="after training, path-trace env 0's final pose "
                             "to this PNG (BASELINE config 5's eval-render "
                             "leg)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    import dataclasses

    import torch

    from d3d12renderer_tpu_torch.cuda_build import resolve_device
    from d3d12renderer_tpu_torch.learning.loco_env import LocoEnv
    from d3d12renderer_tpu_torch.learning.monitor import MonitorCSV, summarize
    from d3d12renderer_tpu_torch.learning.ppo import PPOConfig, make_ppo
    from d3d12renderer_tpu_torch.utils.checkpoint import CheckpointManager

    device = resolve_device(args.device)
    config = PPOConfig(num_envs=args.envs, rollout_steps=args.rollout,
                       minibatches=8, epochs=4)
    if args.lr is not None:
        config = dataclasses.replace(config, learning_rate=args.lr)
    if args.ent_coef is not None:
        config = dataclasses.replace(config, ent_coef=args.ent_coef)

    rank, ranks = 0, 1
    if args.mesh > 1:
        import torch.distributed as dist

        from d3d12renderer_tpu_torch.parallel.data_parallel import (
            join_process_group, make_distributed_ppo)

        if int(os.environ.get("WORLD_SIZE", "1")) != args.mesh:
            raise RuntimeError(
                f"--mesh {args.mesh} trains over {args.mesh} torch.distributed "
                "ranks: launch it with `torchrun --nproc-per-node "
                f"{args.mesh} examples/torch_train_locomotion.py --mesh "
                f"{args.mesh} ...` (WORLD_SIZE is "
                f"{os.environ.get('WORLD_SIZE', 'unset')})")
        group, device = join_process_group(device)
        rank, ranks = dist.get_rank(group), args.mesh
        init, train_iteration, _ = make_distributed_ppo(
            LocoEnv(device=device), config, group)
        if rank == 0:
            print(f"data-parallel over {ranks} ranks, "
                  f"{args.envs * ranks} envs total")
    else:
        env = LocoEnv(device=device)
        init, train_iteration, _ = make_ppo(env, config)

    state = init(0)
    writer = rank == 0
    if writer:
        os.makedirs(args.logdir, exist_ok=True)
        ckpts = CheckpointManager(os.path.join(args.logdir, "checkpoints"))
        monitor = MonitorCSV(os.path.join(args.logdir, "episodes.csv"))

    steps_per_iter = args.envs * args.rollout * ranks
    t0 = time.perf_counter()
    iter_times, losses = [], []
    for it in range(args.iterations):
        t_it = time.perf_counter()
        state, metrics = train_iteration(state)
        r = float(metrics["reward_mean"])      # a host read: ends the iteration
        iter_times.append(time.perf_counter() - t_it)
        losses.append({k: float(metrics[k]) for k in ("pg_loss", "vf_loss",
                                                      "entropy")})
        if writer and (it % 5 == 0 or it == args.iterations - 1):
            dt = time.perf_counter() - t0
            ep = summarize(state.stats)
            print(f"iter {it:4d}  reward/step {r:.3f}  "
                  f"ep-return {ep['mean_return']:.1f} "
                  f"({int(ep['episodes'])} eps)  done-rate "
                  f"{float(metrics['episode_done_rate']):.4f}  "
                  f"vf_loss {losses[-1]['vf_loss']:.4f}  "
                  f"{steps_per_iter * (it + 1) / dt:,.0f} env-steps/s")
            monitor.write(steps_per_iter * (it + 1), state.stats)
            ckpts.save(it, state.params, metric=r)

    if writer:
        print(f"trained {args.iterations * steps_per_iter:,} env-steps in "
              f"{time.perf_counter() - t0:.1f}s; checkpoints in {args.logdir}")
    if writer and len(iter_times) > 3:
        # The steady state: the first iteration (the kernels' build) left
        # out, the median of the rest.
        steady = sorted(iter_times[1:])
        med = statistics.median(steady)
        print(f"steady-state: {steps_per_iter / med:,.0f} env-steps/s incl. "
              f"updates (median iter {med * 1e3:.0f} ms; "
              f"best {steps_per_iter / steady[0]:,.0f}/s)")

    image = None
    if writer and args.eval_render:
        from PIL import Image

        from d3d12renderer_tpu_torch.render.physics_viz import (
            render_physics_state)

        bodies = state.env_state.bodies
        bodies0 = bodies.replace(**{f: getattr(bodies, f)[0] for f in (
            "pos", "rot", "vel", "omega", "force", "torque")})
        arch = LocoEnv(device=device).arch
        t_r = time.perf_counter()
        image = render_physics_state(arch, bodies0, eye=EVAL_EYE,
                                     target=EVAL_TARGET, size=EVAL_SIZE,
                                     spp=EVAL_SPP)
        os.makedirs(os.path.dirname(os.path.abspath(args.eval_render)),
                    exist_ok=True)
        Image.fromarray(image).save(args.eval_render)
        print(f"eval render: wrote {args.eval_render} "
              f"({time.perf_counter() - t_r:.1f}s, mean luma "
              f"{image.mean():.1f})")
    return {"losses": losses, "iter_s": iter_times, "rank": rank,
            "image": image}


if __name__ == "__main__":
    main()
