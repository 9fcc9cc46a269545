"""The gear-train vehicle driving across a procedural heightfield on the
port (counterpart of examples/vehicle_terrain.py), through
`entry.vehicle_terrain_entry`: split-Jacobi contacts at 60 Hz, the motor
hinge at `--throttle` rad/s, steering straight; on the card the frames
after the first replay a CUDA graph.  `--render` path-traces the final
pose to a PNG (the BVH ray kernel on the card).  Runs on the card by
default; `--device cpu` runs on the CPU.

Usage: python examples/torch_vehicle_terrain.py [--seconds 6]
       [--throttle 10] [--device cuda|cpu] [--render build/examples/drive.png]
"""

import argparse
import os
import sys
import time

# Allow `python examples/x.py` without installing the package (the repo
# root is the import root).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

DT = 1.0 / 60.0
RENDER_SIZE, RENDER_SPP = 256, 6


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seconds", type=float, default=6.0)
    parser.add_argument("--throttle", type=float, default=10.0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--render", default=None,
                        help="write a path-traced PNG of the final pose")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from d3d12renderer_tpu_torch.cuda_build import resolve_device
    from d3d12renderer_tpu_torch.entry import vehicle_terrain_entry
    from d3d12renderer_tpu_torch.models import scenes
    from d3d12renderer_tpu_torch.terrain.heightmap import (
        sample_height_bilinear)

    device = resolve_device(args.device)
    fn, (arch, info, state) = vehicle_terrain_entry(
        device=device, batch=1, throttle=args.throttle)
    heights = torch.from_numpy(scenes.vehicle_terrain_heights())
    origin, cell = scenes.VEHICLE_TERRAIN_ORIGIN, scenes.VEHICLE_TERRAIN_CELL
    motor = info.bodies["motor"]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    frames = int(args.seconds / DT)
    t0 = time.perf_counter()
    state, _ = fn(state, 1)
    sync()
    print(f"first frame: {time.perf_counter() - t0:.1f}s on {device}")
    start = state.pos[0, motor].cpu().numpy()
    t0 = time.perf_counter()
    if frames > 1:
        state, _ = fn(state, frames - 1)
    sync()
    dt = time.perf_counter() - t0
    end = state.pos[0, motor].cpu().numpy()
    dist = float(np.linalg.norm((end - start)[[0, 2]]))
    ty, _ = sample_height_bilinear(heights, origin, cell,
                                   torch.tensor(float(end[0])),
                                   torch.tensor(float(end[2])))
    ty = float(ty)
    finite = bool(torch.isfinite(state.pos).all())
    print(f"{frames} frames in {dt:.1f}s ({frames / max(dt, 1e-9):.0f} fps)")
    print(f"drove {dist:.2f} m across the terrain; chassis at "
          f"{end.round(2)} (ground {ty:.2f})")
    print(f"clearance above terrain: {end[1] - ty:.2f} m; all finite: "
          f"{finite}")
    out = {"distance": dist, "clearance": float(end[1] - ty),
           "finite": finite, "seconds": dt}

    if args.render:
        from PIL import Image

        from d3d12renderer_tpu_torch.render.physics_viz import (
            render_physics_state)

        one = state.replace(**{f: getattr(state, f)[0] for f in (
            "pos", "rot", "vel", "omega", "force", "torque")})
        img = render_physics_state(
            arch, one, eye=(end[0] + 5.0, end[1] + 3.5, end[2] + 6.0),
            target=tuple(float(x) for x in end), size=RENDER_SIZE,
            spp=RENDER_SPP)
        os.makedirs(os.path.dirname(os.path.abspath(args.render)),
                    exist_ok=True)
        Image.fromarray(img).save(args.render)
        print(f"wrote {args.render}")
        out["image"] = img
    return out


if __name__ == "__main__":
    main()
