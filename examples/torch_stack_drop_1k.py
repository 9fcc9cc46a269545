"""BASELINE config 1 on the port: a box / sphere stack drop of 1k bodies,
contacts only (counterpart of examples/stack_drop_1k.py).

A jittered grid of boxes and spheres (`models.scenes.add_stack_drop_1k`)
drops onto a ground plane and settles.  Candidate pairs come from the
runtime sweep-and-prune broadphase; contacts solve in mass-splitting
Jacobi mode, through `entry.stack_drop_entry` (on the card it replays a
CUDA graph of the frame after one eager frame).  Runs on the card by
default; `--device cpu` runs on the CPU.

Usage: python examples/torch_stack_drop_1k.py [--bodies 1000] [--steps 300]
       [--batch 1] [--iterations 30] [--device cuda|cpu]
"""

import argparse
import os
import sys
import time

# Allow `python examples/x.py` without installing the package (the repo
# root is the import root).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# examples/stack_drop_1k.py:86: frames per timed chunk, the first untimed.
CHUNK = 25


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--bodies", type=int, default=1000)
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--iterations", type=int, default=30)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from d3d12renderer_tpu_torch.cuda_build import resolve_device
    from d3d12renderer_tpu_torch.entry import stack_drop_entry

    device = resolve_device(args.device)
    fn, (_, st) = stack_drop_entry(device=device, bodies=args.bodies,
                                   batch=args.batch,
                                   contact_mode="split_jacobi",
                                   iterations=args.iterations)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    st, _ = fn(st, CHUNK)
    sync()
    print(f"first {CHUNK} steps (eager frame and graph capture on the "
          f"card): {time.perf_counter() - t0:.1f}s on {device}")
    done = CHUNK
    while done < args.steps:
        done += CHUNK
    t0 = time.perf_counter()
    if done > CHUNK:
        st, _ = fn(st, done - CHUNK)
    sync()
    dt = time.perf_counter() - t0
    steps = (done - CHUNK) * args.batch
    print(f"{done - CHUNK} steps x {args.batch} scenes in {dt:.2f}s "
          f"({steps / max(dt, 1e-9):,.1f} scene-steps/s, "
          f"{steps * args.bodies / max(dt, 1e-9) / 1e6:,.2f}M "
          "body-steps/s)")

    ys = st.pos[..., 1]
    low, far = float(ys.min()), float(st.pos.abs().max())
    print(f"heights: min {low:.3f} max {float(ys.max()):.3f} "
          f"mean {float(ys.mean()):.3f}")
    if not low > -0.2:
        raise RuntimeError("bodies sank through the floor")
    if not far < 100.0:
        raise RuntimeError("explosion")
    speed = torch.linalg.norm(st.vel, dim=-1)
    print(f"speed: mean {float(speed.mean()):.3f} "
          f"max {float(speed.max()):.3f}")
    return {"min_height": low, "max_abs": far, "frames": done,
            "mean_speed": float(speed.mean()), "seconds": dt}


if __name__ == "__main__":
    main()
