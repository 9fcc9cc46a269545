"""Drop a small pile of boxes and a sphere onto the ground plane on the
port (counterpart of examples/stack_drop.py): contact generation and the
colored sequential-impulse solve end to end.  On the card each step's
solve is one launch of the colored-solver kernel (the boxes' pair rows
keep the scene outside the fused kernel's family).  Runs on the card by
default; `--device cpu` runs on the CPU.

Usage: python examples/torch_stack_drop.py [--batch N] [--steps N]
                                           [--device cuda|cpu]
Prints the final resting heights: boxes ~[0.5, 1.5, 2.5], sphere ~0.4.
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
    parser.add_argument("--batch", type=int, default=0,
                        help="0 = single scene")
    parser.add_argument("--steps", type=int, default=400)
    parser.add_argument("--device", default="cuda")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from d3d12renderer_tpu_torch.cuda_build import resolve_device
    from d3d12renderer_tpu_torch.models.scenes import add_stack_drop
    from d3d12renderer_tpu_torch.physics import step
    from d3d12renderer_tpu_torch.physics.builder import SceneBuilder
    from d3d12renderer_tpu_torch.physics.types import PhysicsSettings

    device = resolve_device(args.device)
    b = SceneBuilder()
    add_stack_drop(b)
    arch, state = b.finalize(device=device)
    n_scenes = args.batch or 1
    state = state.replace(**{f: getattr(state, f).expand(
        (n_scenes,) + getattr(state, f).shape[1:]).contiguous()
        for f in ("pos", "rot", "vel", "omega", "force", "torque")})
    settings = PhysicsSettings()
    h = 1.0 / settings.frame_rate

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with torch.inference_mode():
        t0 = time.perf_counter()
        state = step.physics_step(arch, state, settings, h, 1)[0]
        sync()
        print(f"kernels' build + first step: {time.perf_counter() - t0:.2f}s "
              f"on {device}")
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state = step.physics_step(arch, state, settings, h, 1)[0]
        sync()
    el = time.perf_counter() - t0
    print(f"{args.steps} steps x {n_scenes} scenes in {el:.2f}s "
          f"({args.steps * n_scenes / max(el, 1e-9):,.0f} scene-steps/s)")
    heights = state.pos[0, :, 1].cpu()
    print("final body heights:", [round(float(y), 3) for y in heights])
    print("expected: boxes ~[0.5, 1.5, 2.5], sphere ~0.4")
    return {"heights": heights.tolist(), "seconds": el,
            "finite": bool(torch.isfinite(state.pos).all())}


if __name__ == "__main__":
    main()
