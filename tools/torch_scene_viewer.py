"""Scene viewer on the port (`d3d12renderer_tpu_torch.scene.viewer`): the
static HTML page of a scene, or the live HTTP viewer with play mode and
undo.  Runs on the card by default; `--device cpu` runs on the CPU.

Usage:
  python tools/torch_scene_viewer.py scene.yaml [--out scene.html]
      [--size 256] [--views 4] [--spp 6] [--device cuda|cpu]
  python tools/torch_scene_viewer.py scene.yaml --serve [--port 8710]
  python tools/torch_scene_viewer.py --demo --serve   # built-in demo scene
"""

import argparse
import os
import sys

# Allow `python tools/x.py` without installing the package (the repo root
# is the import root).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("scene", nargs="?", default=None,
                        help="scene YAML file")
    parser.add_argument("--out", default=None)
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--views", type=int, default=4)
    parser.add_argument("--spp", type=int, default=6)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--orbit-radius", type=float, default=None)
    parser.add_argument("--serve", action="store_true",
                        help="run the live HTTP viewer instead of writing "
                             "HTML")
    parser.add_argument("--port", type=int, default=8710)
    parser.add_argument("--demo", action="store_true",
                        help="use the built-in multi-object demo scene")
    args = parser.parse_args(argv)
    if args.scene is None and not args.demo:
        parser.error("scene YAML required (or pass --demo)")
    if args.views < 1 and not args.serve:
        parser.error("--views must be >= 1")

    from d3d12renderer_tpu_torch.scene import viewer
    from d3d12renderer_tpu_torch.scene.scene import Scene

    scene = (viewer.build_demo_scene() if args.demo
             else Scene.load_yaml(args.scene))
    if args.serve:
        viewer.serve(scene, args.port, args.size, args.spp, args.device,
                     args.orbit_radius)
        return
    title = args.scene or "demo"
    out = args.out or (title.rsplit(".", 1)[0] + ".html")
    page = viewer.write_static(scene, out, title, args.size, args.views,
                               args.spp, args.device, args.orbit_radius)
    print(f"wrote {out} ({len(page['rows'])} entities, "
          f"{len(page['views'])} views)")


if __name__ == "__main__":
    main()
