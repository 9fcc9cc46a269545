"""Per-kernel time and roofline report of the port (counterpart of
tools/perf_report.py): each row's function timed in its steady state by
`core.profiling.kernel_report` (CUDA events on the card), beside the
least time the card could take for the same work (`bound_ms`: the larger
of the bytes it must move over the HBM rate and its operations over the
fp32 peak).  `FlopCounterMode` sees nothing inside a hand-written kernel,
so the bound of a kernel's row is counted from the row's inputs by the
helpers `chip_smoke.py` uses (`core/profiling.py`: `bound`, `ray_bound`,
`pair_tests_needed` / `pair_bound`, `blur_work`, `tonemap_bound`,
`solve_bound`, `env_step_bound`, `solve_flop`); rows of plain PyTorch give
no bound.  Every table carries the card's name and power limit.  A row
that fails fails the run (after the rows before it are printed).

Rows: the locomotion env step (kernel #2), kernel #3 over
`sphere_grid_scene(16, 26)` on coherent tile-ordered rays, incoherent
rays (alone and regrouped in the call) and any-hit, and over the ~495k-
triangle `sphere_grid_scene(44, 88)` (its tree through the BVH disk cache:
the report gives the build's seconds on a miss and on a hit), kernel #4 on
a 322-triangle scene, kernel #7 at 1080p beside the library blur (pad and
two depthwise `conv2d`), kernel #6 alone and with the plain sharpen,
kernel #5 (pair mode) on the atrium at 1080p, kernel #1 on the plane-only
ragdoll, and a 128^2 cloth step.

Usage: python tools/torch_perf_report.py [--device cuda|cpu] [--out PATH]
       [--iters 10] [--warmup 2]
"""

import argparse
import os
import sys
import tempfile
import time

# Allow `python tools/x.py` without installing the package (the repo root
# is the import root).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# Sizes by device: the card's are tools/perf_report.py's (the env at batch
# 1024, 64k rays, the grids, 1080p images, the atrium); the CPU's are cut
# so that the plain versions finish (the env at batch 64, as the JAX tool
# runs it off the TPU).
SIZES = {
    "cuda": dict(env_batch=1024, rays=65536, ray_w=256, ray_h=256,
                 grid=(16, 26), big_grid=(44, 88), image=(1080, 1920),
                 atrium=1.4, raster=(1920, 1080), solver_batch=4096,
                 cloth=128),
    "cpu": dict(env_batch=64, rays=1024, ray_w=32, ray_h=32, grid=(4, 6),
                big_grid=(8, 12), image=(64, 96), atrium=0.2,
                raster=(128, 72), solver_batch=64, cloth=32),
}
BLUR_SIGMA = 2.0
# Solver iterations (the env's default) and the ragdoll's steps before its
# solve is timed (chip_smoke.py's ITERATIONS and WARM_STEPS).
ITERATIONS = 30
WARM_STEPS = 20
CLOTH_DT = 1 / 240.0


class Row:
    """A report row: `fn(*args)` timed; `bound()` -> (ms, by) or None."""

    def __init__(self, name, kernel, fn, args, bound=None):
        self.name, self.kernel = name, kernel
        self.fn, self.args, self.bound = fn, args, bound


def coherent_rays(torch, device, w, h, rays):
    """tools/perf_report.py:45-58: camera-like directions from (0, 1.5,
    -9) in the path tracer's 32x32 tile order, repeated to `rays`."""
    import numpy as np

    from d3d12renderer_tpu_torch.render.pathtracer import _tile_perm

    xs = (np.arange(w) + 0.5) / w * 2 - 1
    ys = (np.arange(h) + 0.5) / h * 2 - 1
    dc = np.stack(np.broadcast_arrays(xs[None, :] * 0.9, -ys[:, None] * 0.55,
                                      np.full((h, w), 1.0)), -1).reshape(-1, 3)
    dc = (dc / np.linalg.norm(dc, axis=-1, keepdims=True)).astype(np.float32)
    perm = _tile_perm(w, h)[0]
    perm = perm.cpu().numpy() if hasattr(perm, "cpu") else np.asarray(perm)
    dc = np.resize(dc[perm], (rays, 3))
    o = torch.tensor([0.0, 1.5, -9.0], device=device).expand(rays, 3)
    return o.contiguous(), torch.as_tensor(dc, device=device)


def incoherent_rays(torch, device, rays, seed):
    """tools/perf_report.py:59-65: normal directions biased along +z."""
    import numpy as np

    rng = np.random.default_rng(seed)
    d = rng.normal(size=(rays, 3)).astype(np.float32)
    d[:, 2] += 1.5
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.as_tensor(d, device=device)


def ray_rows(torch, device, size, timings):
    """Kernel #3 (and #4 on the small scene) rows."""
    from d3d12renderer_tpu_torch.core import profiling
    from d3d12renderer_tpu_torch.ops import ray_trace as rt
    from d3d12renderer_tpu_torch.render import bvh as bvh_mod
    from d3d12renderer_tpu_torch.render import mesh

    o, dc = coherent_rays(torch, device, size["ray_w"], size["ray_h"],
                          size["rays"])
    di = incoherent_rays(torch, device, size["rays"], 0)
    tm = torch.full((size["rays"],), 1e30, device=device)

    def bound_of(b, kernel, d, any_hit=False):
        def count():
            if device.type != "cuda":
                return None
            planes, nodes = rt.kernel_tables(b)
            stats = torch.zeros(2, dtype=torch.int64, device=device)
            if kernel == "bvh":
                rt.ray_closest_hit_bvh(planes, nodes, o, d, tm, any_hit,
                                       stats=stats)
            else:
                rt.ray_closest_hit_brute(planes, o, d, tm, any_hit,
                                         stats=stats)
            tests, boxes = stats.tolist()
            return profiling.ray_bound(o.shape[0], tests, boxes, 1,
                                       planes.shape[0], nodes.shape[0],
                                       rt.PLANE_COLS, rt.NODE_COLS)
        return count

    def query(b, kernel, any_hit=False):
        planes, nodes = rt.kernel_tables(b)
        if kernel == "bvh":
            return lambda o_, d_: rt.ray_closest_hit_bvh(
                planes, nodes, o_, d_, tm, any_hit)[0]
        return lambda o_, d_: rt.ray_closest_hit_brute(planes, o_, d_, tm,
                                                       any_hit)[0]

    b = bvh_mod.build_bvh(mesh.sphere_grid_scene(*size["grid"]),
                          device=device)
    tris = int(b.tri_valid.sum())
    tag = f"{size['rays'] // 1024}k rays, {tris / 1000:.1f}k tris"
    yield Row(f"BVH walk, coherent tiles ({tag})", "#3",
              query(b, "bvh"), (o, dc), bound_of(b, "bvh", dc))
    yield Row(f"BVH walk, incoherent ({tag})", "#3", query(b, "bvh"),
              (o, di), bound_of(b, "bvh", di))
    yield Row(f"BVH walk, incoherent + in-call regroup ({tag})", "#3",
              lambda o_, d_: bvh_mod.closest_hit(b, o_, d_,
                                                 regroup=True)["t"],
              (o, di))
    yield Row(f"BVH walk, any-hit shadow ({tag})", "#3",
              query(b, "bvh", any_hit=True), (o, dc),
              bound_of(b, "bvh", dc, any_hit=True))

    # The ~495k-triangle grid, its tree through the disk cache: a miss
    # (build and write) into a fresh directory, then a hit.
    big = mesh.sphere_grid_scene(*size["big_grid"])
    with tempfile.TemporaryDirectory() as cache_dir:
        old = os.environ.get(bvh_mod.BVH_CACHE_DIR_ENV)
        os.environ[bvh_mod.BVH_CACHE_DIR_ENV] = cache_dir
        try:
            for kind in ("miss", "hit"):
                t0 = time.perf_counter()
                bb = bvh_mod.build_bvh(big, device=device, cache=True)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                timings[f"big-grid tree, cache {kind} (s)"] = (
                    time.perf_counter() - t0)
        finally:
            if old is None:
                del os.environ[bvh_mod.BVH_CACHE_DIR_ENV]
            else:
                os.environ[bvh_mod.BVH_CACHE_DIR_ENV] = old
    big_tris = int(bb.tri_valid.sum())
    db = incoherent_rays(torch, device, size["rays"], 1)
    tag = f"{size['rays'] // 1024}k rays, {big_tris / 1000:.1f}k tris"
    yield Row(f"BVH walk, coherent ({tag})", "#3", query(bb, "bvh"),
              (o, dc), bound_of(bb, "bvh", dc))
    yield Row(f"BVH walk, incoherent + in-call regroup ({tag})", "#3",
              lambda o_, d_: bvh_mod.closest_hit(bb, o_, d_,
                                                 regroup=True)["t"],
              (o, db))

    # The brute force on a scene of one 1024-row chunk (the counterpart of
    # the JAX tool's dense-table row).
    small = bvh_mod.build_bvh([(mesh.quad(5.0), 0), (mesh.ico_sphere(
        1.0, 2).transformed(translate=(0, 1.0, 0)), 1)], device=device)
    yield Row(f"brute force, coherent ({size['rays'] // 1024}k rays, "
              f"{int(small.tri_valid.sum())} tris)", "#4",
              query(small, "brute"), (o, dc), bound_of(small, "brute", dc))


def image_rows(torch, device, size):
    """Kernels #7 and #6 at the frame's size, the library blur beside."""
    import torch.nn.functional as F

    from d3d12renderer_tpu_torch.core import profiling
    from d3d12renderer_tpu_torch.ops import image
    from d3d12renderer_tpu_torch.render import post

    h, w = size["image"]
    img = torch.rand((h, w, 3), generator=torch.Generator(
        device=device).manual_seed(1), device=device) * 4.0
    taps = image.gaussian_kernel(BLUR_SIGMA)
    r = (taps.numel() - 1) // 2
    yield Row(f"gaussian blur {w}x{h}x3, sigma {BLUR_SIGMA}", "#7",
              lambda x: image.gaussian_blur(x, taps), (img,),
              lambda: profiling.bound(*profiling.blur_work(img.numel(), r)))
    wv = taps.to(device).view(1, 1, -1, 1).expand(3, 1, -1, 1).contiguous()
    wh = taps.to(device).view(1, 1, 1, -1).expand(3, 1, 1, -1).contiguous()

    def library(x):
        y = F.pad(x.permute(2, 0, 1)[None], (r, r, r, r), mode="replicate")
        return F.conv2d(F.conv2d(y, wv, groups=3), wh, groups=3)

    yield Row(f"library blur {w}x{h}x3 (pad + two depthwise conv2d)",
              "library", library, (img,))
    settings = post.TonemapSettings()
    yield Row(f"tonemap {w}x{h}x3", "#6",
              lambda x: image.tonemap(x, settings), (img,),
              lambda: profiling.tonemap_bound(img.numel()))
    yield Row(f"tonemap + sharpen {w}x{h}x3", "#6, #7",
              lambda x: post.sharpen(post.tonemap_uncharted2(x)), (img,))


def raster_row(torch, device, size):
    """Kernel #5's pair mode on the atrium's frame."""
    from d3d12renderer_tpu_torch.core import profiling
    from d3d12renderer_tpu_torch.entry import _atrium
    from d3d12renderer_tpu_torch.ops import raster
    from d3d12renderer_tpu_torch.render import mesh

    w, h = size["raster"]
    scene, cam = _atrium(device, w, h, mesh.atrium_scene(size["atrium"]))
    b = scene.bvh
    wp, hp = w + (-w) % raster.TILE_X, h + (-h) % raster.TILE_Y
    mat, attr = raster.perspective_rows(cam, w, h)
    planes, rect, q_tri = raster.project_planes(
        b.tri_v0, b.tri_e1, b.tri_e2, b.tri_valid, mat, attr, wp, hp)
    pair_tri, seg = raster.bin_pairs(rect, q_tri, wp, hp)[:2]
    jitter = torch.tensor([0.3, 0.7], device=device)
    args = (planes, pair_tri, seg, jitter, wp, hp)

    def bound():
        q = raster.rasterize_plain(*args)[0]
        needed = profiling.pair_tests_needed(raster, planes, pair_tri, seg,
                                             q, jitter, wp, hp)
        return profiling.pair_bound(raster, planes, int(seg[-1]),
                                    seg, needed, wp, hp)

    yield Row(f"raster pair mode, atrium {int(b.tri_valid.sum())} tris at "
              f"{w}x{h} ({int(seg[-1])} pairs)", "#5",
              raster.rasterize_tiles, args, bound)


def physics_rows(torch, device, size):
    """The env step (kernel #2), the ragdoll's colored solve (kernel #1)
    and a cloth step."""
    from d3d12renderer_tpu_torch.core import profiling
    from d3d12renderer_tpu_torch.learning.loco_env import (ACTION_SIZE,
                                                           FRAME_RATE,
                                                           STATE_SIZE,
                                                           LocoEnv)
    from d3d12renderer_tpu_torch.physics import solver_cuda, step
    from d3d12renderer_tpu_torch.physics.cloth import (create_cloth,
                                                       simulate)
    from d3d12renderer_tpu_torch.physics.types import PhysicsSettings

    batch = size["env_batch"]
    env = LocoEnv(settings=PhysicsSettings(frame_rate=FRAME_RATE,
                                           solver_iterations=ITERATIONS),
                  device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    _, st = env.reset(batch, gen)
    act = torch.zeros((batch, ACTION_SIZE), device=device)

    def env_bound():
        sp = step.substep_prep(env.arch, st.bodies, 1.0 / FRAME_RATE,
                               env.settings, env._motor_overrides(act))
        solver = solver_cuda.ColoredSolver(
            env.arch, sp.contacts.body_a.shape[0], ITERATIONS, "plain")
        return profiling.env_step_bound(
            batch, st.bodies.pos.shape[1], ACTION_SIZE, STATE_SIZE,
            solver.tables, int(sp.contact_prep.pmask.sum()), ITERATIONS)

    yield Row(f"loco env step (batch {batch})", "#2",
              lambda s, a: env.step(s, a)[1], (st, act), env_bound)

    # The plane-only ragdoll's solve, as chip_smoke.py's phase 3 holds it:
    # the preps of a disturbed batch after WARM_STEPS unfused steps.
    sb = size["solver_batch"]
    uenv = LocoEnv(settings=PhysicsSettings(frame_rate=FRAME_RATE,
                                            solver_iterations=ITERATIONS,
                                            fused_substep="off"),
                   device=device)
    _, ust = uenv.reset(sb, gen)
    with torch.inference_mode():
        for _ in range(WARM_STEPS):
            a = torch.rand((sb, ACTION_SIZE), generator=gen,
                           device=device) * 2.0 - 1.0
            _, ust, _, _ = uenv.step(ust, a)
        sp = step.substep_prep(uenv.arch, ust.bodies, 1.0 / FRAME_RATE,
                               uenv.settings, uenv._motor_overrides(a))
    solver = solver_cuda.ColoredSolver(uenv.arch, sp.contacts.body_a.shape[0],
                                       ITERATIONS, "auto")
    prep = solver.pack_prep(sp.joint_preps, sp.contact_prep, sb, device)
    if device.type == "cuda":
        arrays = solver.kernel_arrays(device)

        def solve(vel, omega):
            return solver_cuda.colored_solve_cuda(
                vel, omega, prep, arrays, len(solver.tables),
                solver.num_impulses, ITERATIONS)
    else:
        def solve(vel, omega):
            return solver.plain(sp.joint_preps, sp.contact_prep, vel, omega)
    yield Row(f"colored solve, plane-only ragdoll (batch {sb}, "
              f"{ITERATIONS} iterations)", "#1", solve,
              (sp.vel1.contiguous(), sp.omega1.contiguous()),
              lambda: profiling.solve_bound(
                  prep.numel(), sp.vel1.numel(), solver.tables, sb,
                  int(sp.contact_prep.pmask.sum()), ITERATIONS))

    n = size["cloth"]
    params, cloth = create_cloth(2.0, 2.0, n, n, total_mass=1.0,
                                 device=device)
    yield Row(f"cloth {n}^2 step", "plain",
              lambda s: simulate(params, s, CLOTH_DT), (cloth,))


def rows(torch, device, size, timings):
    yield from physics_rows(torch, device, size)
    yield from ray_rows(torch, device, size, timings)
    yield from image_rows(torch, device, size)
    yield from raster_row(torch, device, size)


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=None,
                        help="also write the markdown table here")
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--warmup", type=int, default=2)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from d3d12renderer_tpu_torch.core.profiling import (card_name_and_power,
                                                        kernel_report)
    from d3d12renderer_tpu_torch.cuda_build import resolve_device

    device = resolve_device(args.device)
    size = SIZES[device.type]
    card = (card_name_and_power() or "nvidia-smi not found"
            if device.type == "cuda" else "the CPU (no card)")
    lines = [
        f"# Kernel roofline report: {card}",
        "",
        "Generated by `tools/torch_perf_report.py` through",
        "`core.profiling.kernel_report` (steady state, CUDA events on the",
        "card).  `bound` is the least time of the row's work on one H100",
        "SXM (3.35 TB/s HBM, 67 TFLOP/s fp32), counted from the row's inputs",
        "by the helpers chip_smoke.py uses; `-` where the row is plain",
        "PyTorch, or for the ray kernels on the CPU (their work counters run",
        "only on the card).  `bound / ms` only for a run on the card.",
        "",
        "| row | kernel | ms | bound ms (by) | bound / ms | GB/s counted |",
        "|---|---|---|---|---|---|",
    ]
    print("\n".join(lines), flush=True)
    results, timings = [], {}
    with torch.inference_mode():
        for row in rows(torch, device, size, timings):
            rep = kernel_report(row.fn, *row.args, iters=args.iters,
                                warmup=args.warmup)
            ms = rep["device_s_per_call"] * 1e3
            b = row.bound() if row.bound is not None else None
            share = f"{b[0] / ms:.3f}" if b and device.type == "cuda" else "-"
            bcol = f"{b[0]:.4f} ({b[1]}) | {share}" if b else "- | -"
            lines.append(f"| {row.name} | {row.kernel} | {ms:.4f} | {bcol} | "
                         f"{rep['achieved_gbps']:.1f} |")
            print(lines[-1], flush=True)
            results.append({"name": row.name, "kernel": row.kernel, "ms": ms,
                            "bound_ms": b[0] if b else None,
                            "bound_by": b[1] if b else None})
    lines.append("")
    for name, s in timings.items():
        lines.append(f"- {name}: {s:.3f}")
        print(lines[-1], flush=True)
    text = "\n".join(lines) + "\n"
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out}")
    return {"rows": results, "timings": timings, "card": card,
            "text": text}


if __name__ == "__main__":
    main()
