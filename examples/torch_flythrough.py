"""Animated flythrough on the port (counterpart of examples/flythrough.py):
physics running under the raster frame while an orbiting camera films it,
the offline analogue of the reference's interactive 1920x1080 editor loop
(src/main.cpp:121: the update loop stepping physics and rendering every
frame), through `entry.flythrough_entry`.

Per frame, on the device: one physics step of two 120 Hz substeps (the
colored-solver kernel on the card), the instances posed on the device
(the per-frame BVH), then the whole raster frame: sun cascades (the BVH ray
kernel), the raster primary (the raster kernel), tiled lights, AO, SSR, TAA
with the moving camera's motion vectors (`prev_camera`), bloom (the blur
kernel), tonemap (the tonemap kernel).  Writes an animated GIF and reports
ms/frame.  The port's frame takes the raster primary (JAX's script,
`RendererSettings()`, the ray primary).  Runs on the card by default;
`--device cpu` runs on the CPU.

Usage: python examples/torch_flythrough.py [--size 256] [--frames 48]
       [--device cuda|cpu] [--out build/examples/flythrough.gif]
"""

import argparse
import os
import sys

# Allow `python examples/x.py` without installing the package (the repo
# root is the import root).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "build", "examples")
# examples/flythrough.py:148-150: 50 ms a GIF frame, looping.
GIF_FRAME_MS = 50


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--frames", type=int, default=48)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out",
                        default=os.path.join(OUT_DIR, "flythrough.gif"))
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch
    from PIL import Image

    from d3d12renderer_tpu_torch.entry import flythrough_entry

    # The script films from the pile's first frame, as JAX's does.
    out = flythrough_entry(device=args.device, width=args.size,
                           height=args.size, frames=args.frames,
                           settle_frames=0)
    ms = out["ms_per_frame"]
    print(f"kernels' build + frame 0: {out['frame_ms'][0] / 1e3:.1f}s; "
          f"steady: {ms:.0f} ms/frame ({args.size}x{args.size}, "
          f"{args.frames} frames)")
    frames = [(torch.clamp(f, 0, 1) * 255).to(torch.uint8).cpu().numpy()
              for f in out["frames"]]
    imgs = [Image.fromarray(f) for f in frames]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    imgs[0].save(args.out, save_all=True, append_images=imgs[1:],
                 duration=GIF_FRAME_MS, loop=0)
    heights = out["state"].pos[0, :, 1].cpu()
    print(f"wrote {args.out}; final body heights min "
          f"{float(heights.min()):.2f} / max {float(heights.max()):.2f}")
    return {"frames": frames, "ms_per_frame": ms,
            "heights": heights.tolist()}


if __name__ == "__main__":
    main()
