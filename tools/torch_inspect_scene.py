"""CLI scene inspector on the port: the headless editor substitute
(counterpart of tools/inspect_scene.py, the same printout).

Prints the entity tree with components and the physics compilation, and
with `--render` path-traces one view to PNG through the port (on the card
by default; `--device cpu` runs on the CPU).

Usage:
  python tools/torch_inspect_scene.py scene.yaml [--render out.png]
      [--size 256] [--spp 8] [--eye 6,4,8] [--target 0,1,0]
      [--device cuda|cpu]
"""

import argparse
import os
import sys

# Allow `python tools/x.py` without installing the package (the repo root
# is the import root).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def vec(s):
    return tuple(float(x) for x in s.split(","))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("scene", help="scene YAML file")
    parser.add_argument("--render", default=None, help="write a PNG view")
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--spp", type=int, default=8)
    parser.add_argument("--eye", default="6,4,8")
    parser.add_argument("--target", default="0,1,0")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from d3d12renderer_tpu_torch.scene.scene import Scene

    scene = Scene.load_yaml(args.scene)
    print(f"Scene: {args.scene}")
    print(f"  planes: {len(scene.planes)}")
    entities = list(scene.view())
    print(f"  entities: {len(entities)}")
    for ent, _ in entities:
        comps = [k for k in scene._components if ent.has(k)]
        print(f"    [{ent.id:3d}] {ent.name:<24} {', '.join(comps)}")
        for k in comps:
            v = ent.get(k)
            if k == "collider":
                for c in v:
                    print(f"          collider: {c.shape} size={c.size} "
                          f"density={c.density}")
            elif k == "transform":
                print(f"          at {tuple(round(x, 3) for x in v.position)}")

    arch, state, mapping = scene.compile_physics(device=args.device)
    print(f"  physics: {arch.num_bodies} bodies, {arch.num_colliders} "
          f"colliders, {arch.num_planes} planes, {arch.num_terrains} "
          f"terrains")
    total_pairs = sum(b.body_a.shape[0] for b in arch.contact_buckets)
    print(f"           {arch.vs_plane_collider.shape[0]} plane rows, "
          f"{total_pairs} pair rows, "
          f"{len(arch.contact_color_indices)} contact colors")
    for t in arch.joints:
        print(f"           {t.body_a.shape[0]} {t.kind} joints")

    if args.render:
        import math

        from d3d12renderer_tpu_torch.render.camera import look_at
        from d3d12renderer_tpu_torch.scene import viewer

        rscene = scene.build_render_scene(body_state=state, mapping=mapping,
                                          device=args.device)
        cam = look_at(eye=vec(args.eye), target=vec(args.target), aspect=1.0,
                      v_fov=math.radians(50), device=args.device)
        img = viewer.beauty(rscene, cam, args.size, args.spp)
        with open(args.render, "wb") as f:
            f.write(viewer.png_bytes(img))
        print(f"  wrote {args.render}")


if __name__ == "__main__":
    main()
