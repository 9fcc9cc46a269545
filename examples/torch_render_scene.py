"""Path-trace a demo scene to PNG on the port (counterpart of
examples/render_scene.py): red, metal and blue shapes and a green torus on
a gray ground under the procedural sky, depth 3 with sun NEE and MIS; its
ray queries go through the brute-force or BVH ray kernel on the card.
Runs on the card by default; `--device cpu` runs on the CPU.

Usage: python examples/torch_render_scene.py [--size 512] [--spp 16]
       [--device cuda|cpu] [--out build/examples/render.png]
       [--point-lights]
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
ALBEDO = [[0.45, 0.45, 0.45], [0.75, 0.15, 0.12], [0.95, 0.93, 0.88],
          [0.15, 0.3, 0.75], [0.2, 0.7, 0.3]]
ROUGHNESS = [0.7, 0.35, 0.12, 0.5, 0.4]
METALLIC = [0.0, 0.0, 1.0, 0.0, 0.0]


def demo_meshes(mesh_mod):
    """examples/render_scene.py:44-51: ground, sphere, metal sphere, box
    and torus with materials 0-4."""
    ground = mesh_mod.quad(half=30.0)
    sphere = mesh_mod.ico_sphere(1.0, 3).transformed(translate=(0, 1.0, 0))
    metal = mesh_mod.ico_sphere(0.8, 3).transformed(
        translate=(-2.2, 0.8, 0.6))
    box = mesh_mod.box((0.7, 0.7, 0.7)).transformed(
        translate=(2.2, 0.7, -0.5),
        rotate=(0.0, math.sin(0.3), 0.0, math.cos(0.3)))
    torus = mesh_mod.torus(0.9, 0.3).transformed(translate=(0.8, 0.3, 2.2))
    return [(ground, 0), (sphere, 1), (metal, 2), (box, 3), (torus, 4)]


def demo_materials(pt, device):
    import torch

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    return pt.Materials(albedo=f32(ALBEDO),
                        emissive=torch.zeros((5, 3), device=device),
                        roughness=f32(ROUGHNESS), metallic=f32(METALLIC))


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--size", type=int, default=512)
    parser.add_argument("--spp", type=int, default=16)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=os.path.join(OUT_DIR, "render.png"))
    parser.add_argument("--point-lights", action="store_true",
                        help="add two local point lights (NEE + MIS path)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch
    from PIL import Image

    from d3d12renderer_tpu_torch.cuda_build import resolve_device
    from d3d12renderer_tpu_torch.render import bvh as bvh_mod
    from d3d12renderer_tpu_torch.render import mesh as mesh_mod
    from d3d12renderer_tpu_torch.render import pathtracer as pt
    from d3d12renderer_tpu_torch.render.camera import look_at

    device = resolve_device(args.device)
    bvh = bvh_mod.build_bvh(demo_meshes(mesh_mod), device=device)
    point_lights = None
    if args.point_lights:
        from d3d12renderer_tpu_torch.render.lights import make_point_lights

        point_lights = make_point_lights(
            positions=[[-1.0, 2.5, 2.0], [2.8, 2.0, 1.5]],
            colors=[[9000.0, 7000.0, 4000.0], [2000.0, 4000.0, 9000.0]],
            radii=[18.0, 18.0], device=device)
    scene = pt.Scene(bvh=bvh, materials=demo_materials(pt, device),
                     sky=pt.default_sky(device=device),
                     point_lights=point_lights).with_shading_table()
    cam = look_at((6, 3.2, 7), (0, 0.8, 0), device=device, aspect=1.0,
                  v_fov=math.radians(45))
    settings = pt.PathTracerSettings(recursion_depth=3)

    def frame(seed):
        sampler = pt.Sampler(torch.Generator(device=device).manual_seed(seed))
        with torch.inference_mode():
            img, _ = pt.render(scene, cam, args.size, args.size, settings,
                               spp=args.spp, sampler=sampler)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return img

    t0 = time.perf_counter()
    frame(0)
    t1 = time.perf_counter()
    img = frame(1)
    t2 = time.perf_counter()
    rays = args.size * args.size * args.spp * (settings.recursion_depth + 1) * 2
    print(f"kernels' build + render: {t1 - t0:.1f}s; steady render: "
          f"{t2 - t1:.2f}s (~{rays / (t2 - t1) / 1e6:.1f} Mrays/s incl. "
          "shadow rays)")
    arr = pt.to_srgb_u8(img).cpu().numpy()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    Image.fromarray(arr).save(args.out)
    print(f"wrote {args.out} ({args.size}x{args.size}, {args.spp} spp), "
          f"mean luma {arr.mean():.1f}")
    return {"image": arr, "seconds": t2 - t1}


if __name__ == "__main__":
    main()
