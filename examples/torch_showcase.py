"""The "everything on" demo frame on the port (counterpart of
examples/showcase.py), through `entry.showcase_world_entry`: terrain in LOD
chunks with its splat texture, water, culled grass, placed trees, bodies
settled on the terrain, sun cascades plus spot and point shadows from one
atlas, probe ambient, RT reflections blended with SSR, a decal, a glass
slab, half-res AO and SSS, TAA, bloom, tonemap, sharpen, and fire
particles splatted onto the tonemapped frame.  On the card the settle runs
the colored-solver kernel, the atlas, probes and reflections the BVH ray
kernel, the glass the brute-force ray kernel, and each frame the raster,
tonemap and blur kernels.  The port's frame takes the raster primary
(JAX's script, `RendererSettings(...)`, the ray primary).  Runs on the card
by default; `--device cpu` runs on the CPU.

Usage: python examples/torch_showcase.py [--size 256] [--device cuda|cpu]
       [--out build/examples/showcase.png] [--physics-steps 180]
       [--audio OUT.WAV] [--envmap PATH|procedural]
"""

import argparse
import os
import sys
import time

# Allow `python examples/x.py` without installing the package (the repo
# root is the import root).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "build", "examples")
# examples/showcase.py:366-371: the first frame, then two steady ones.
FRAMES = 3


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out",
                        default=os.path.join(OUT_DIR, "showcase.png"))
    parser.add_argument("--physics-steps", type=int, default=180)
    parser.add_argument("--audio", default=None, metavar="OUT.WAV",
                        help="mix collision-impact sounds from the physics "
                             "settle into a stereo WAV")
    parser.add_argument("--envmap", default=None,
                        help="HDR equirect .hdr/.exr for the textured sky; "
                             "'procedural' for the gradient sky; default: "
                             "the committed examples/data/studio.hdr")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch
    from PIL import Image

    from d3d12renderer_tpu_torch.cuda_build import resolve_device
    from d3d12renderer_tpu_torch.entry import showcase_world_entry
    from d3d12renderer_tpu_torch.models import world as world_mod

    device = resolve_device(args.device)
    envmap = (None if args.envmap == "procedural"
              else args.envmap or world_mod.ENVMAP)
    t_start = time.perf_counter()
    fn, state = showcase_world_entry(
        device=device, width=args.size, height=args.size, audio=args.audio,
        config=world_mod.WorldConfig(physics_frames=args.physics_steps),
        envmap=envmap)
    world = fn.world
    c = world.counts
    if fn.audio is not None:
        print(f"audio: {len(fn.audio['impacts'])} impact events -> "
              f"{fn.audio['path']} ({fn.audio['seconds']:.1f}s)")
    heights = [round(float(y), 2) for y in world.bodies.pos[0, :, 1]]
    print(f"physics settled ({args.physics_steps} frames): heights {heights}")
    print(f"placement: {c['trees']} trees")
    print(f"grass: {c['visible_blades']} visible blades in "
          f"{c['visible_chunks']} chunks (LOD0 {c['lod0_blades']} / LOD1 "
          f"{c['lod1_blades']})")
    print(f"scene: {c['triangles']} triangles, {c['meshes']} meshes, "
          f"{c['chunks']} terrain LOD chunks")
    if envmap is not None:
        print(f"HDR envmap: {envmap} (max radiance {c['envmap_peak']:.0f})")
    print(f"shadow atlas: {len(world.atlas.viewports)} viewports, "
          f"{world.atlas.cache.misses} rendered")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    ldr, state, aux = fn(state)
    sync()
    print(f"frame, kernels' build included: {time.perf_counter() - t0:.1f}s")
    for _ in range(1, FRAMES):
        t0 = time.perf_counter()
        ldr, state, aux = fn(state)
        sync()
    steady_ms = (time.perf_counter() - t0) * 1e3
    print(f"steady frame: {steady_ms:.0f} ms")

    arr = (torch.clamp(ldr, 0, 1) * 255).to(torch.uint8).cpu().numpy()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    Image.fromarray(arr).save(args.out)
    alive = int(world.fire.alive.sum())
    print(f"wrote {args.out}; total {time.perf_counter() - t_start:.0f}s; "
          f"mean luma {arr.mean():.1f}; particles alive {alive}")
    return {"image": arr, "counts": c, "heights": heights,
            "viewports": len(world.atlas.viewports), "alive": alive,
            "audio": fn.audio, "steady_ms": steady_ms}


if __name__ == "__main__":
    main()
