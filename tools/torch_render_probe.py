"""Times the port's render kernels on one GPU at the main paths' shapes:
the tile rasterizer (`csrc/raster.cu`) on the atrium at 1920x1080; the BVH
ray kernel (`csrc/ray_trace.cu` `ray_closest_hit_bvh`) on the atrium's
1080p primary and bounce wavefronts (the bounces also regrouped, as the path
tracer queries them); the brute-force ray kernel (`ray_closest_hit_brute`)
on the 322-triangle scene's 1080p primary wavefront and on bounces off it
(distinct origins);
the blur (`csrc/image.cu` `gaussian_blur`) at the raster frame's seven
shapes (CUDA events, and the kernel's device time from the profiler) beside
the library blur (replicate pad and two depthwise `conv2d`);
the tonemap (`csrc/image.cu` `tonemap`) at 1080p RGB: its device time from
the profiler with a cold L2 (a 100 MB write before each call) and a warm
one, the wrapper's host time per call and CUDA events over back-to-back
calls, after checking it on a 16-byte-aligned input, a view at offset 1
and an odd length;
each kernel held against its plain version on the card first; then the
raster query end to end, the path-traced frame (`entry.pathtrace_entry`)
and the small scene's path-traced frame with its brute-force kernel time.
It also prints ptxas's registers, shared memory and stack of each kernel,
and the SASS instructions of one rounded division (`cuobjdump -sass` of a
one-line kernel).
`--only groups` times instead the group mode of the tile rasterizer
(`raster_groups`) and the pair kernel (`raster_tiles`) on the character
crowd's first frame at 1080p (chip_smoke.py's characters phase), and prints
the visits per tile, the group kernel's counters, its bound and its
instruction floor (the bound's tests times the SASS instructions per test of
the kernel's inner loop, over every lane of the card at its largest SM
clock), both from this checkout's `core/profiling.py`.

    python3 tools/torch_render_probe.py [--repo DIR] [--label NAME]
        [--only tonemap|groups]

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
BLUR_REPS = 50
TONEMAP_REPS = 100
# CUDA's expf / logf against PyTorch's exp / log: 2 ulps of 1.0
# (chip_smoke.py's SRGB_TOL).
SRGB_TOL = 2.4e-7
FRAMES = 5
# chip_smoke.py's characters phase: its jitters' seed and count.
CROWD_SEED, CROWD_FRAMES = 11, 8
RAY_SUBSET = 16384
W, H = 1920, 1080
# chip_smoke.py's BLUR_SHAPES: the raster frame's seven blur calls.
BLUR_SHAPES = (((540, 960, 1), 1.5), ((1080, 1920, 3), 1.5),
               ((540, 960, 3), 1.5), ((270, 480, 3), 1.5),
               ((135, 240, 3), 1.5), ((67, 120, 3), 1.5),
               ((1080, 1920, 3), 1.0))
# One rounded division and one rounded product, for their SASS.
DIV_SOURCE = """
extern "C" __global__ void one_div(const float* a, const float* b, float* c) {
  c[threadIdx.x] = __fdiv_rn(a[threadIdx.x], b[threadIdx.x]);
}
extern "C" __global__ void one_mul(const float* a, const float* b, float* c) {
  c[threadIdx.x] = __fmul_rn(a[threadIdx.x], b[threadIdx.x]);
}
"""


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def wavefront(torch, dev, cam):
    """The camera's 1080p rays in the path tracer's tile order."""
    from d3d12renderer_tpu_torch.render import camera as cam_mod
    from d3d12renderer_tpu_torch.render import pathtracer as pt

    o, d = cam_mod.generate_rays(cam, W, H)
    perm = torch.as_tensor(pt._tile_perm(W, H)[0], device=dev)
    return o[perm].contiguous(), d[perm].contiguous()


def bounces(torch, dev, b, o, d):
    """Rays from the hits of (o, d), cosine-distributed about the geometric
    normal that faces the ray (chip_smoke.py's bounce wavefront): distinct
    origins."""
    from d3d12renderer_tpu_torch.render import bvh as bvh_mod

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
    return bo, torch.nn.functional.normalize(bd, dim=-1).contiguous()


def division_sass(build_dir):
    """SASS opcodes of one `__fdiv_rn` and of one `__fmul_rn` kernel: up to
    the first EXIT (the path every operand takes that needs no slow-path
    fix-up) and in all (the slow path included)."""
    from d3d12renderer_tpu_torch import cuda_build

    nvcc = cuda_build._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    src = build_dir / "one_div.cu"
    src.write_text(DIV_SOURCE)
    cubin = build_dir / "one_div.cubin"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-cubin", str(src), "-o", str(cubin)], check=True,
                   capture_output=True, text=True)
    sass = subprocess.run([cuobjdump, "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split(":")[1].strip()
            out[name] = []
        elif name and "/*" in line and ";" in line:
            op = line.split("*/", 1)[1].strip().split(";")[0].split()
            if op:
                out[name].append(op[1] if op[0].startswith("@") else op[0])
    counts = {}
    for fn, ops in out.items():
        body = [x for x in ops if x not in ("NOP",)]
        first_exit = body.index("EXIT") + 1 if "EXIT" in body else len(body)
        counts[fn] = {"to_first_exit": first_exit, "all": len(body),
                      "ops": body}
    return counts


def kernel_sass(lib, name):
    """SASS opcodes and branch targets of the kernel whose mangled name holds
    `name`, from `cuobjdump -sass` of the built library: [(address, opcode,
    target or None)]."""
    from d3d12renderer_tpu_torch import cuda_build

    cuobjdump = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    out, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            if inside:
                break
            inside = name in line
        elif inside and "/*" in line and ";" in line:
            addr = int(line.split("/*")[1].split("*/")[0], 16)
            op = line.split("*/", 1)[1].strip().split(";")[0].split()
            if not op:
                continue
            code = op[1] if op[0].startswith("@") else op[0]
            target = None
            if code.startswith("BRA"):
                hexes = [t for t in op if t.startswith("0x")]
                target = int(hexes[-1].rstrip(","), 16) if hexes else None
            out.append((addr, code, target))
    if not out:
        fail(f"no SASS for {name}")
    return out


def inner_loop(sass):
    """(instructions, pixels) of the plane test's loop, one pass per row:
    the smallest backward-branch loop holding at least one pixel's 8
    products (FMUL); its pixels are its whole multiples of 8 products."""
    loops = []
    for addr, _, target in sass:
        if target is not None and target < addr:
            body = [c for a, c, _ in sass if target <= a <= addr]
            fmul = sum(c.startswith("FMUL") for c in body)
            if fmul >= 8:
                loops.append((len(body), fmul // 8))
    return min(loops)


def crowd_frame(torch, dev):
    """The character crowd's first frame at 1080p as chip_smoke.py's
    characters phase builds it (`character_entry`, a warm frame, then the
    frame at the first of its seeded jitters): (fn, state, BVH, camera,
    jitter)."""
    from d3d12renderer_tpu_torch.entry import character_entry

    fn, state = character_entry(device=dev, width=W, height=H)
    _, state, _ = fn(state)
    jit = torch.rand((CROWD_FRAMES, 2), generator=torch.Generator()
                     .manual_seed(CROWD_SEED)).to(dev)[0]
    _, state, aux = fn(state, jitter=jit)
    return fn, state, aux["bvh"], fn.camera, jit


def bounds_module():
    """This checkout's `core/profiling.py` (the bound helpers), loaded by
    path, so that `--repo` on another checkout keeps the same
    yardstick."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "d3d12renderer_tpu_torch", "core",
        "profiling.py")
    spec = importlib.util.spec_from_file_location("profiling_bounds", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def group_probe(torch, dev, sync, emit, cuda_ms, lib):
    """The group kernel and the pair kernel on the crowd's first frame at
    1080p, each against its plain version; the visits per tile; the group
    kernel's counters; its bound and instruction floor (`core/profiling.py`'s
    `group_bound` and `instruction_floor_ms`; where the package has
    `group_rows_needed`); then the crowd's frames (`character_entry`, host
    clock, best of 3 runs of CROWD_FRAMES) and one frame's stages (CUDA
    events)."""
    from d3d12renderer_tpu_torch.ops import raster

    fn, state, bvh, cam, jit = crowd_frame(torch, dev)
    hp = H + (-H) % raster.TILE_Y
    mat, attr = raster.perspective_rows(cam, W, H)
    tables = raster.build_frame_tables(bvh.tri_v0, bvh.tri_e1, bvh.tri_e2,
                                       bvh.tri_valid, mat, attr, W, hp)
    plan = raster.visit_plan(tables, W, hp, jit)
    per_tile = (plan.seg[1:] - plan.seg[:-1]).long()
    edges = [0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1 << 30]
    emit(probe="group visits per tile", rows=int(tables.planes.shape[0]),
         tiles=int(per_tile.numel()), visits=plan.visits,
         mean=per_tile.float().mean().item(), max=int(per_tile.max()),
         histogram={f"{lo}-{hi - 1}": int(((per_tile >= lo)
                                           & (per_tile < hi)).sum())
                    for lo, hi in zip(edges, edges[1:])},
         heaviest=torch.sort(per_tile, descending=True).values[:16].tolist())
    want = raster.rasterize_groups_plain(tables, plan, jit, W, hp)
    bands = getattr(raster, "GROUP_BANDS", 1)
    stats = torch.zeros(4 if bands > 1 else 2, dtype=torch.int64,
                        device=dev)
    got = raster.rasterize_groups(tables, plan, jit, W, hp, stats=stats)
    sync()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        fail("the group kernel differs from its plain version")
    least = raster.tile_min(want[0], W, hp)
    counters = dict(zip(("visits_run", "visits_skipped", "rows_tested",
                         "rows_culled"), stats.tolist()))
    g_bound = None
    if hasattr(raster, "group_rows_needed"):
        g_bound = bounds_module().group_bound(raster, tables, plan, want[0],
                                             jit, W, hp)
        counters["rows_needed"] = g_bound[2] // (raster.PX
                                                 // raster.GROUP_BANDS)
    emit(probe="group kernel counters", bands=bands, visits=plan.visits,
         visits_needed=int((plan.bound > least[plan.visit_tile]).sum()),
         **counters)
    g_ms = cuda_ms(lambda: raster.rasterize_groups(tables, plan, jit, W, hp))
    planes, rect, q_tri = raster.project_planes(
        bvh.tri_v0, bvh.tri_e1, bvh.tri_e2, bvh.tri_valid, mat, attr, W, hp)
    pair_tri, seg = raster.bin_pairs(rect, q_tri, W, hp)[:2]
    pair_args = (planes, pair_tri, seg, jit, W, hp)
    if not all(torch.equal(a, b) for a, b in zip(
            raster.rasterize_tiles(*pair_args),
            raster.rasterize_plain(*pair_args))):
        fail("the pair kernel differs from its plain version")
    p_ms = cuda_ms(lambda: raster.rasterize_tiles(*pair_args))
    emit(kernel="raster_groups", ms=g_ms, pair_kernel_ms=p_ms,
         pairs=int(seg[-1]), reps=REPS, bit_equal=True)
    loop, pixels = inner_loop(kernel_sass(lib, "raster_groups"))
    per_test = loop / pixels
    if g_bound is not None:
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True).stdout.split()[0])
        floor = bounds_module().instruction_floor_ms
        emit(probe="group bound", bound_ms=g_bound[0], bound_by=g_bound[1],
             tests=g_bound[2], tile_tests=g_bound[3],
             loop_instructions=loop, pixels_per_pass=pixels,
             instructions_per_test=per_test, sm_clock_mhz=mhz,
             instruction_floor_ms=floor(g_bound[2], per_test, mhz),
             tile_instruction_floor_ms=floor(g_bound[3], per_test, mhz),
             kernel_ms=g_ms)
    best = math.inf
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        for _ in range(CROWD_FRAMES):
            _, state, _ = fn(state)
        sync()
        best = min(best, (time.perf_counter() - t0) / CROWD_FRAMES)
    _, state, staged = fn(state, profile_stages=True)
    emit(probe="crowd frame", frame_ms=1e3 * best,
         stage_ms=staged["stage_ms"])


def brute_probe(torch, dev, sync, emit, cuda_ms):
    """The brute-force kernel on chip_smoke.py's 322-triangle scene: the
    tile-ordered 1080p primary wavefront and a bounce wavefront off its
    hits, each held against the plain version on a strided subset, with
    the kernel's work counters; then the scene's path-traced frame (1080p,
    depth 3) with the brute-force kernel's device time per frame."""
    from torch.autograd import DeviceType

    from d3d12renderer_tpu_torch.ops import ray_trace as rt
    from d3d12renderer_tpu_torch.render import bvh as bvh_mod
    from d3d12renderer_tpu_torch.render import camera as cam_mod
    from d3d12renderer_tpu_torch.render import mesh
    from d3d12renderer_tpu_torch.render import pathtracer as pt

    b = bvh_mod.build_bvh([(mesh.quad(5.0), 0), (mesh.ico_sphere(1.0, 2)
                           .transformed(translate=(0, 1.0, 0)), 1)],
                          device=dev)
    cam = cam_mod.look_at((0.0, 2.5, 6.0), (0.0, 1.0, 0.0), device=dev,
                          v_fov=math.radians(60), aspect=W / H)
    o, d = wavefront(torch, dev, cam)
    planes = rt.kernel_tables(b)[0]
    for wf, (ro, rd) in (("primary", (o, d)),
                         ("bounce", bounces(torch, dev, b, o, d))):
        for mode in ("closest", "any"):
            tm = torch.full((ro.shape[0],), 1e30, device=dev)
            idx = torch.arange(0, ro.shape[0], ro.shape[0] // RAY_SUBSET,
                               device=dev)[:RAY_SUBSET]
            so, sd, stm = ro[idx].contiguous(), rd[idx].contiguous(), tm[idx]
            wt, wtri = rt.closest_hit_plain(planes, so, sd, stm)
            err = rt.new_error_word(dev)
            any_hit = mode == "any"

            def run(oo=ro, dd=rd, tt=tm, s=None):
                return rt.ray_closest_hit_brute(planes, oo, dd, tt, any_hit,
                                                stats=s, error=err)

            t, tri = run(so, sd, stm)
            sync()
            differ = (int(((tri >= 0) != (wtri >= 0)).sum()) if any_hit
                      else int((tri != wtri).sum()) + int((t != wt).sum()))
            stats = torch.zeros(2, dtype=torch.int64, device=dev)
            run(s=stats)
            ms = cuda_ms(run)
            rt.raise_on_error(err)
            emit(kernel="ray_closest_hit_brute", wavefront=wf, mode=mode,
                 rays=ro.shape[0], rows=planes.shape[0], ms=ms,
                 differ_on_subset=differ, tests=stats.tolist()[0])
            if differ:
                fail(f"the brute-force kernel differs from the plain version "
                     f"({wf}, {mode})")

    scene = pt.Scene(
        bvh=b, materials=pt.Materials(
            albedo=torch.tensor([[0.5, 0.5, 0.5], [0.8, 0.2, 0.1]],
                                device=dev),
            emissive=torch.zeros((2, 3), device=dev),
            roughness=torch.tensor([0.7, 0.3], device=dev),
            metallic=torch.tensor([0.0, 0.0], device=dev)),
        sky=pt.default_sky(device=dev)).with_shading_table()
    settings = pt.PathTracerSettings(recursion_depth=3)
    sampler = pt.Sampler(torch.Generator(device=dev).manual_seed(2))

    def frame():
        with torch.inference_mode():
            return pt.render(scene, cam, W, H, settings, 1, sampler)

    frame()
    sync()
    t0 = time.perf_counter()
    for _ in range(FRAMES):
        frame()
    sync()
    frame_ms = 1e3 * (time.perf_counter() - t0) / FRAMES
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        frame()
        sync()
    brute_us = [e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == DeviceType.CUDA
                and "ray_closest_hit_brute" in e.name]
    emit(kernel="small-scene path-traced frame", frame_ms=frame_ms,
         brute_ms_per_frame=sum(brute_us) / 1e3, brute_launches=len(brute_us),
         brute_ms_each=[u / 1e3 for u in brute_us])


def blur_probe(torch, dev, sync, emit):
    """The blur at the raster frame's seven shapes, bit-equal to its plain
    version, beside the library blur: replicate pad and two depthwise 1-D
    `conv2d` (TF32 off)."""
    import torch.nn.functional as F
    from torch.autograd import DeviceType

    from d3d12renderer_tpu_torch.ops import image

    torch.backends.cudnn.allow_tf32 = False

    def ms_of(fn):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        sync()
        start.record()
        for _ in range(BLUR_REPS):
            fn()
        end.record()
        sync()
        return start.elapsed_time(end) / BLUR_REPS

    gen = torch.Generator(device=dev).manual_seed(3)
    total = {"ms": 0.0, "device_ms": 0.0, "library_ms": 0.0}
    for shape, sigma in BLUR_SHAPES:
        x = torch.rand(shape, generator=gen, device=dev) * 4.0
        taps = image.gaussian_kernel(sigma)
        got = image.gaussian_blur(x, taps)
        same = torch.equal(got, image.blur_plain(x, taps.to(dev)))
        if not same:
            fail(f"the blur kernel differs from its plain version at {shape}")
        r, c = taps.shape[0] // 2, shape[2]
        tv = taps.to(dev)
        wv = tv.view(1, 1, -1, 1).expand(c, 1, -1, 1).contiguous()
        wh = tv.view(1, 1, 1, -1).expand(c, 1, 1, -1).contiguous()
        y = x.permute(2, 0, 1)[None]

        def library():
            z = F.pad(y, (r, r, r, r), mode="replicate")
            return F.conv2d(F.conv2d(z, wv, groups=c), wh, groups=c)

        ms = ms_of(lambda: image.gaussian_blur(x, taps))
        lib_ms = ms_of(library)
        # The kernel's own device time: the events above also hold the
        # host's time per launch where it exceeds the kernel's.
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(BLUR_REPS):
                image.gaussian_blur(x, taps)
            sync()
        dev_us = [e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and "gaussian_blur" in e.name]
        device_ms = sum(dev_us) / 1e3 / max(1, len(dev_us))
        total["ms"] += ms
        total["device_ms"] += device_ms
        total["library_ms"] += lib_ms
        emit(kernel="gaussian_blur", shape=list(shape), sigma=sigma, ms=ms,
             device_ms=device_ms, library_ms=lib_ms, bit_equal=same)
    emit(kernel="gaussian_blur, the frame's 7", **total)


def tonemap_probe(torch, dev, sync, emit):
    """The tonemap at 1080p RGB (the raster frame's call): against its plain
    version on an aligned input, a view at offset 1 and an odd length, both
    encodes; then its times with the sRGB encode off."""
    from torch.autograd import DeviceType

    from d3d12renderer_tpu_torch.ops import image
    from d3d12renderer_tpu_torch.render import post

    settings = post.TonemapSettings()
    k = image.tonemap_constants(settings)
    gen = torch.Generator(device=dev).manual_seed(5)
    base = torch.rand(H * W * 3 + 8, generator=gen, device=dev) * 20.0
    x = base[:H * W * 3].view(H, W, 3)
    for name, xs in (("aligned", x), ("offset 1", base[1:H * W * 3 + 1]),
                     ("odd length", base[3:H * W * 3 - 2])):
        for srgb in (False, True):
            got = image.tonemap(xs, settings, srgb)
            want = image.tonemap_plain(xs, k, srgb)
            err = (got - want).abs().max().item()
            if not (torch.equal(got, want) if not srgb else err <= SRGB_TOL):
                fail(f"the tonemap kernel differs from its plain version "
                     f"({name}, srgb={srgb}, max |diff| {err:.3e})")

    def tone():
        return image.tonemap(x, settings)

    tone()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(TONEMAP_REPS):
        tone()
    host_ms = 1e3 * (time.perf_counter() - t0) / TONEMAP_REPS
    end.record()
    sync()
    events_ms = start.elapsed_time(end) / TONEMAP_REPS
    flush = torch.empty(100 * 2 ** 20 // 4, device=dev)
    marker = torch.zeros(1, device=dev)
    out = {}
    # "cold": the 100 MB write before each call (chip_smoke.py's), which
    # leaves the L2 full of dirty lines that the call's traffic writes
    # back; "cold read": a 100 MB read instead, which leaves clean ones.
    for kind, sep in (("cold", flush.zero_), ("cold read", flush.sum),
                      ("warm", lambda: marker.add_(1.0))):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(TONEMAP_REPS):
                sep()
                tone()
            sep()
            sync()
        # The tonemap launches seen between two separators (a session may
        # miss its first kernels).
        ev = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
        whole = [ev[i].time_range.elapsed_us() for i in range(1, len(ev) - 1)
                 if "tonemap" in ev[i].name and "tonemap" not in
                 ev[i - 1].name and "tonemap" not in ev[i + 1].name]
        if len(whole) < TONEMAP_REPS // 2:
            fail(f"the profiler saw {len(whole)} tonemap calls whole ({kind})")
        out[kind] = sum(whole) / len(whole) / 1e3
    emit(kernel="tonemap", shape=[H, W, 3], device_ms_cold_l2=out["cold"],
         device_ms_cold_l2_read=out["cold read"],
         device_ms_warm_l2=out["warm"], host_ms_per_call=host_ms,
         events_ms=events_ms, calls=TONEMAP_REPS)


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=here)
    ap.add_argument("--label", default="change")
    ap.add_argument("--only", choices=["tonemap", "groups"], default=None,
                    help="time only this kernel")
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
        if "Compiling entry function" in line and any(
                k in line for k in ("raster_tiles", "raster_groups",
                                    "ray_closest_hit", "gaussian_blur",
                                    "tonemap")):
            emit(ptxas=line.split("'")[1], props=" ".join(
                x.strip() for x in log[i + 1:i + 4]
                if "stack frame" in x or "registers" in x))
    if opts.only == "groups":
        group_probe(torch, dev, sync, emit, cuda_ms, lib)
        return
    tonemap_probe(torch, dev, sync, emit)
    if opts.only == "tonemap":
        return
    emit(division_sass=division_sass(lib.parent))

    # The brute-force kernel and the blur first: their redesign is what
    # the parent is compared with.
    brute_probe(torch, dev, sync, emit, cuda_ms)
    blur_probe(torch, dev, sync, emit)

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
    pairs = int(seg[-1])
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
    o, d = wavefront(torch, dev, cam)
    bo, bd = bounces(torch, dev, b, o, d)
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
