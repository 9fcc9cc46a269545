"""Times the port's two render kernels on one GPU at the main paths' shapes:
the tile rasterizer (`csrc/raster.cu`) on the atrium at 1920x1080 and the
BVH ray kernel (`csrc/ray_trace.cu` `ray_closest_hit_bvh`) on the atrium's
1080p primary and bounce wavefronts (the bounces also regrouped, as the path
tracer queries them), each held against the plain version on the card
first; then the raster query end to end and the path-traced frame
(`entry.pathtrace_entry`).

    python3 tools/torch_render_probe.py [--repo DIR] [--label NAME]

`--repo` imports `d3d12renderer_tpu_torch` from another checkout (an older
commit unpacked with `git archive`), so that two versions are timed in one
call on one card, in turns.  Every measurement is one JSON line on stdout:
CUDA-event times over REPS launches after a warm launch, the kernels' work
counters, the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

REPS = 20
FRAMES = 5
RAY_SUBSET = 16384
W, H = 1920, 1080


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=here)
    ap.add_argument("--label", default="change")
    opts = ap.parse_args()
    sys.path.insert(0, os.path.abspath(opts.repo))
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this probe runs only on a GPU")
    from torch.autograd import DeviceType

    from d3d12renderer_tpu_torch import cuda_build
    from d3d12renderer_tpu_torch.entry import pathtrace_entry
    from d3d12renderer_tpu_torch.ops import raster
    from d3d12renderer_tpu_torch.ops import ray_trace as rt
    from d3d12renderer_tpu_torch.render import bvh as bvh_mod
    from d3d12renderer_tpu_torch.render import camera as cam_mod
    from d3d12renderer_tpu_torch.render import mesh
    from d3d12renderer_tpu_torch.render import pathtracer as pt

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]

    def emit(**kw):
        print(json.dumps({"label": opts.label, "card": card, **kw}),
              flush=True)

    def cuda_ms(fn):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        sync()
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        sync()
        return start.elapsed_time(end) / REPS

    lib = cuda_build.build_library()
    log = (lib.parent / "build.log").read_text().splitlines()
    for i, line in enumerate(log):
        if "Compiling entry function" in line and (
                "raster_tiles" in line or "ray_closest_hit_bvh" in line):
            emit(ptxas=line.split("'")[1], props=" ".join(
                x.strip() for x in log[i + 1:i + 4]
                if "stack frame" in x or "registers" in x))

    b = bvh_mod.build_bvh(mesh.atrium_scene(1.4), device=dev)
    cam = cam_mod.look_at((8.0, 6.0, -14.0), (0.0, 3.0, 0.0), device=dev,
                          v_fov=math.radians(60), aspect=W / H)

    # The raster kernel: closest_hit_raster's inputs at a fixed jitter.
    hp = H + (-H) % raster.TILE_Y
    jitter = torch.tensor([0.3, 0.7], device=dev)
    mat, attr = raster.perspective_rows(cam, W, H)
    planes, rect, q_tri = raster.project_planes(
        b.tri_v0, b.tri_e1, b.tri_e2, b.tri_valid, mat, attr, W, hp)
    pair_tri, seg = raster.bin_pairs(rect, q_tri, W, hp)[:2]
    pairs = pair_tri.shape[0]
    culls = hasattr(raster, "BANDS")           # a kernel that counts its cull
    want = raster.rasterize_plain(planes, pair_tri, seg, jitter, W, hp)

    def raster_fn(s=None):
        return raster.rasterize_tiles(planes, pair_tri, seg, jitter, W, hp,
                                      **({"stats": s} if culls else {}))

    got = raster_fn()
    sync()
    same = all(torch.equal(x, y) for x, y in zip(got, want))
    tested_culled = None
    if culls:
        stats = torch.zeros(2, dtype=torch.int64, device=dev)
        raster_fn(stats)
        tested_culled = stats.tolist()
    emit(kernel="raster_tiles", ms=cuda_ms(raster_fn), bit_equal=same,
         pairs=pairs, tested_culled=tested_culled)
    if not same:
        fail("the raster kernel differs from the plain version")

    # The raster query end to end (projection, binning, kernel).
    emit(kernel="closest_hit_raster", ms=cuda_ms(
        lambda: raster.closest_hit_raster(b, cam, W, H, jitter=jitter)))

    # The BVH kernel: the atrium's tile-ordered 1080p primary wavefront and
    # cosine bounces off its hits (chip_smoke.py's wavefronts).
    o, d = cam_mod.generate_rays(cam, W, H)
    perm = torch.as_tensor(pt._tile_perm(W, H)[0], device=dev)
    o, d = o[perm].contiguous(), d[perm].contiguous()
    res = bvh_mod.closest_hit(b, o, d)
    hit = res["hit"]
    tri = res["tri"][hit].long()
    gn = torch.nn.functional.normalize(torch.cross(b.tri_e1[tri], b.tri_e2[tri],
                                                   dim=-1), dim=-1)
    gn = torch.where((torch.sum(gn * d[hit], -1) > 0)[:, None], -gn, gn)
    bo = (o[hit] + d[hit] * res["t"][hit][:, None] + gn * 1e-3).contiguous()
    gen = torch.Generator(device=dev).manual_seed(11)
    u1, u2 = torch.rand((2, bo.shape[0]), generator=gen, device=dev)
    t1 = torch.nn.functional.normalize(torch.cross(
        gn, torch.where(gn[:, :1].abs() > 0.9, torch.tensor(
            [0.0, 1.0, 0.0], device=dev), torch.tensor([1.0, 0.0, 0.0],
                                                       device=dev)), dim=-1),
        dim=-1)
    t2 = torch.cross(gn, t1, dim=-1)
    bd = (t1 * (u1.sqrt() * torch.cos(2 * math.pi * u2))[:, None]
          + t2 * (u1.sqrt() * torch.sin(2 * math.pi * u2))[:, None]
          + gn * (1 - u1).sqrt()[:, None])
    bd = torch.nn.functional.normalize(bd, dim=-1).contiguous()
    rplanes, nodes = rt.kernel_tables(b)
    launch_bvh = cuda_build.launcher("ray_closest_hit_bvh_launch", dev)
    # The bounces as the path tracer queries them: regrouped by direction and
    # origin cell (`regroup_perm`).
    perm = rt.regroup_perm(bo, bd, b.dense.cluster_lo.min(0).values,
                           b.dense.cluster_hi.max(0).values)
    wavefronts = (("primary", (o, d)), ("bounce", (bo, bd)),
                  ("bounce regrouped", (bo[perm].contiguous(),
                                        bd[perm].contiguous())))
    for wf, (ro, rd) in wavefronts:
        tm = torch.full((ro.shape[0],), 1e30, device=dev)
        idx = torch.arange(0, ro.shape[0], ro.shape[0] // RAY_SUBSET,
                           device=dev)[:RAY_SUBSET]
        so, sd, stm = ro[idx].contiguous(), rd[idx].contiguous(), tm[idx]
        wt, wtri = rt.closest_hit_plain(rplanes, so, sd, stm)
        err = rt.new_error_word(dev)

        def run(oo=ro, dd=rd, tt=tm, s=None):
            return rt.launch(launch_bvh, rplanes, nodes, oo, dd, tt, False,
                             stats=s, error=err)

        t, tri_ = run(so, sd, stm)
        sync()
        rt.raise_on_error(err)
        differ = int((tri_ != wtri).sum()) + int((t != wt).sum())
        stats = torch.zeros(2, dtype=torch.int64, device=dev)
        run(s=stats)
        ms = cuda_ms(run)
        rt.raise_on_error(err)
        emit(kernel="ray_closest_hit_bvh", wavefront=wf, rays=ro.shape[0],
             ms=ms, differ_on_subset=differ, nodes=nodes.shape[0],
             per_ray_tests_boxes=[x / ro.shape[0] for x in stats.tolist()])
        if differ:
            fail(f"the BVH kernel differs from the plain version ({wf})")

    # The path-traced frame (pathtrace_entry: the atrium at 1080p, depth 3):
    # host clock over FRAMES frames after a warm one, and one profiled frame
    # for the BVH kernel's device time.
    fn, args = pathtrace_entry(width=W, height=H, recursion_depth=3)
    fn(*args)
    sync()
    t0 = time.perf_counter()
    for _ in range(FRAMES):
        fn(*args)
    sync()
    frame_ms = 1e3 * (time.perf_counter() - t0) / FRAMES
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn(*args)
        sync()
    bvh_us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and "ray_closest_hit_bvh" in e.name]
    emit(kernel="path-traced frame", frame_ms=frame_ms,
         bvh_ms_per_frame=sum(bvh_us) / 1e3, bvh_launches=len(bvh_us))

if __name__ == "__main__":
    main()
