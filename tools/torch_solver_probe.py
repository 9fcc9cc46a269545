"""Times the port's two solver kernels on the card by team width and
iteration count, to split each launch into its fixed part and its cost per
solver iteration.

At B ragdolls (default 4096) after 20 random-action steps, for each team
width of `solver_cuda.TEAM_WIDTHS` and each iteration count of --iterations:
the colored solver (csrc/colored_solver.cu) on the packed prep of that state,
and the fused whole-step kernel (csrc/fused_substep.cu) on the same state,
both by CUDA events over --reps launches.  With --tables, also with the
solve cut to the first k tables of each count given (1: hinge, 2: hinge and
cone-twist, 3: all), which splits the cost per table kind; with
--no-post, also the fused kernel without the env's post stage.  Prints one
JSON object per line, then the card's name and power limit.

    python3 tools/torch_solver_probe.py [--batch 4096] [--iterations 0 1 30]
                                        [--tables 0 1 2] [--no-post]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--iterations", type=int, nargs="+", default=[0, 1, 30])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--tables", type=int, nargs="*", default=[])
    ap.add_argument("--no-post", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this probe runs only on a GPU")
    from d3d12renderer_tpu_torch.learning.loco_env import (
        ACTION_SIZE, FRAME_RATE, LocoEnv)
    from d3d12renderer_tpu_torch.physics import solver_cuda, step, substep_cuda
    from d3d12renderer_tpu_torch.physics.types import PhysicsSettings

    dev, batch = torch.device("cuda"), args.batch

    def cuda_ms(fn):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    gen = torch.Generator(device=dev).manual_seed(7)
    env = LocoEnv(settings=PhysicsSettings(frame_rate=FRAME_RATE,
                                           fused_substep="off"), device=dev)
    _, st = env.reset(batch, gen)
    with torch.inference_mode():
        for _ in range(20):
            act = torch.rand((batch, ACTION_SIZE), generator=gen,
                             device=dev) * 2.0 - 1.0
            _, st, _, _ = env.step(st, act)
        sp = step.substep_prep(env.arch, st.bodies, 1.0 / FRAME_RATE,
                               env.settings, env._motor_overrides(act))
        solver = solver_cuda.ColoredSolver(
            env.arch, sp.contacts.body_a.shape[0], 30, "kernel")
        prep = solver.pack_prep(sp.joint_preps, sp.contact_prep, batch, dev)
        arrays = solver.kernel_arrays(dev)
        consts = substep_cuda.pack_consts(
            env.arch, env.settings, 1.0 / FRAME_RATE, env._action_columns(),
            ACTION_SIZE, dev)
        post = env.post_consts()
        act = act.contiguous()
        print(json.dumps({"batch": batch, "active_contact_points": int(
            sp.contact_prep.pmask.sum())}), flush=True)
        for width in solver_cuda.TEAM_WIDTHS:
            for tables in [len(solver.tables)] + args.tables:
                row = {"team_width": width, "tables": tables}
                for it in args.iterations:
                    row[f"colored_ms_it{it}"] = cuda_ms(
                        lambda: solver_cuda.colored_solve_cuda(
                            sp.vel1, sp.omega1, prep, arrays, tables,
                            solver.num_impulses, it, width))
                    c = dataclasses.replace(consts, iterations=it,
                                            num_tables=tables)
                    row[f"fused_ms_it{it}"] = cuda_ms(
                        lambda: substep_cuda.fused_substep_cuda(
                            st.bodies, act, c, post, width))
                    if args.no_post:
                        row[f"fused_no_post_ms_it{it}"] = cuda_ms(
                            lambda: substep_cuda.fused_substep_cuda(
                                st.bodies, act, c, None, width))
                print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
