"""Render frames of the demo scene through the port's raster pipeline
(counterpart of examples/raster_frame.py): the tile rasterizer's primary
visibility, sun cascades, tiled point lights, HBAO, SSR, TAA, bloom,
tonemap and sharpen, to a PNG.  On the card a frame runs the raster
kernel once, the tonemap once and the blur seven times.  The port's frame
takes the raster primary (`RendererSettings(primary="raster")`); JAX's
script takes `RendererSettings()`, whose primary is "ray".  Runs on the
card by default; `--device cpu` runs on the CPU.

Usage: python examples/torch_raster_frame.py [--size 512] [--width W]
       [--height H] [--frames 4] [--profile-stages] [--device cuda|cpu]
       [--out build/examples/frame.png] [--dump-exr PATH]
"""

import argparse
import math
import os
import sys
import time

# Allow `python examples/x.py` without installing the package (the repo
# root is the import root).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "build", "examples")
# examples/raster_frame.py:90-97: the cascades' resolution and two point
# lights.
SHADOW_RESOLUTION = 512
LIGHTS = dict(positions=[[2.5, 2.0, 2.5], [-3.0, 1.5, -1.0]],
              colors=[[40.0, 10.0, 5.0], [5.0, 10.0, 40.0]], radii=[8.0, 8.0])


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--size", type=int, default=512)
    parser.add_argument("--width", type=int, default=None,
                        help="overrides --size (e.g. 1920)")
    parser.add_argument("--height", type=int, default=None,
                        help="overrides --size (e.g. 1080)")
    parser.add_argument("--profile-stages", action="store_true",
                        help="per-stage times of the last frame (CUDA "
                             "events on the card)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=os.path.join(OUT_DIR, "frame.png"))
    parser.add_argument("--dump-exr", default=None, metavar="PATH",
                        help="also write the pre-tonemap HDR buffer as an EXR")
    parser.add_argument("--frames", type=int, default=4)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch
    from PIL import Image

    from d3d12renderer_tpu_torch.cuda_build import resolve_device
    from d3d12renderer_tpu_torch.render import bvh as bvh_mod
    from d3d12renderer_tpu_torch.render import mesh as mesh_mod
    from d3d12renderer_tpu_torch.render import pathtracer as pt
    from d3d12renderer_tpu_torch.render.camera import look_at
    from d3d12renderer_tpu_torch.render.lights import make_point_lights
    from d3d12renderer_tpu_torch.render.pipeline import (
        RendererSettings, initial_frame_state, render_frame_with_shadows)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_render_scene import demo_materials, demo_meshes

    device = resolve_device(args.device)
    w = args.width or args.size
    h = args.height or args.size
    bvh = bvh_mod.build_bvh(demo_meshes(mesh_mod), device=device)
    scene = pt.Scene(bvh=bvh, materials=demo_materials(pt, device),
                     sky=pt.default_sky(device=device)).with_shading_table()
    cam = look_at((6, 3.2, 7), (0, 0.8, 0), device=device, aspect=w / h,
                  v_fov=math.radians(45))
    lights = make_point_lights(**LIGHTS, device=device)
    settings = RendererSettings(primary="raster")
    generator = torch.Generator(device=device).manual_seed(0)

    def frame(state, profile=False):
        with torch.inference_mode():
            out = render_frame_with_shadows(
                scene, cam, w, h, settings,
                shadow_resolution=SHADOW_RESOLUTION, point_lights=lights,
                frame_state=state, prev_camera=cam,
                jitter=torch.rand(2, generator=generator, device=device),
                profile_stages=profile)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out

    state = initial_frame_state(w, h, device)
    t0 = time.perf_counter()
    ldr, state, aux = frame(state)
    t1 = time.perf_counter()
    for i in range(1, args.frames):
        ldr, state, aux = frame(state, args.profile_stages
                                and i == args.frames - 1)
    t2 = time.perf_counter()
    steady = (t2 - t1) / max(args.frames - 1, 1)
    print(f"kernels' build + frame: {t1 - t0:.1f}s; steady: "
          f"{steady * 1000:.0f} ms/frame ({w}x{h})")
    if "stage_ms" in aux:
        stages = dict(aux["stage_ms"])
        print("per-stage breakdown (last frame, CUDA events on the card):")
        for name, ms in sorted(stages.items(), key=lambda kv: -kv[1]):
            print(f"  {name:16s} {ms:8.2f} ms  "
                  f"({ms / (steady * 1e3) * 100:4.1f}%)")

    arr = (torch.clamp(ldr, 0, 1) * 255).to(torch.uint8).cpu().numpy()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    Image.fromarray(arr).save(args.out)
    if args.dump_exr:
        from d3d12renderer_tpu_torch.assets.image_io import save_exr

        save_exr(args.dump_exr, aux["hdr"].cpu().numpy(), half=True)
        print(f"wrote pre-tonemap HDR to {args.dump_exr}")
    shadowed = float((aux["shadow"] < 0.5).float().mean()) * 100
    print(f"wrote {args.out}; mean luma {arr.mean():.1f}, "
          f"ao min {float(aux['ao'].min()):.2f}, shadowed px {shadowed:.0f}%")
    return {"image": arr, "ms_per_frame": steady * 1e3,
            "stage_ms": aux.get("stage_ms"),
            "hdr_finite": bool(np.isfinite(aux["hdr"].cpu().numpy()).all())}


if __name__ == "__main__":
    main()
