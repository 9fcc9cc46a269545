"""Chip check of the PyTorch / CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels (the colored solver, the fused whole-substep
kernel, the two ray kernels, the path tracer's two shading kernels, the
raster kernel, the blur and the tonemap)
and the native BVH builder from the sources beside this script, holds each
kernel against its plain PyTorch version at its path's shapes, then drives
the paths:

* locomotion (`d3d12renderer_tpu_torch.entry`: policy forward + batched
  ragdoll env step, one fused-kernel launch per step) at 4096 envs, and the
  unfused route whose solve is the colored-solver kernel;
* path tracing (`entry.pathtrace_entry`: the 256,798-triangle atrium at
  1920x1080, depth 3, sun NEE + MIS; its ray queries go through the BVH ray
  kernel, its shading through the two shading kernels, held against the
  plain shading on one frame from one generator state), and a
  322-triangle scene at 1920x1080 whose queries go through the brute-force
  ray kernel;
* the raster frame (`entry.raster_entry`: the atrium at 1920x1080, raster
  primary visibility, sun cascades, half-res HBAO and SSR, TAA, bloom,
  tonemap, sharpen; one raster, one tonemap and seven blur launches per
  frame);
* PPO training (`entry.train_entry`: BASELINE config 5, 4096 envs, rollout
  32, 8 minibatches, 4 epochs; one fused launch per rollout step) and the
  eval render of the trained pose through the BVH ray kernel;
* data-parallel training (`entry.distributed_entry`: NCCL at world size 1,
  the same config per rank, kernel #2 under the all-reduces), its sharded
  checkpoint round trip, and the atrium path-traced in bands
  (`parallel.eval_render.pathtrace_sharded`, the BVH ray kernel);
* the raster frame's options (`entry.raster_showcase_entry`: SSS, RT
  reflections through the BVH ray kernel, spot and point lights with their
  maps in one shadow atlas, probes, a decal, a glass slab through the
  brute-force ray kernel, water; `entry.raster_lights_entry`: 128 point
  lights through the Forward+ tile lists) and the three modes of
  `render_mode`;
* examples/showcase.py's whole world (`entry.showcase_world_entry` at
  1080p: terrain LOD chunks with the splat texture, the drop settled for
  180 frames through the colored-solver kernel, trees, culled grass, the
  HDR sky through the image cache, the atlas and probes through the BVH
  ray kernel, fire particles; its frame runs the ray, raster, tonemap and
  blur kernels);
* examples/flythrough.py's path (`entry.flythrough_entry` at 1080p: 18
  boxes and spheres settled for 60 frames, then 16 frames filmed by an
  orbiting camera, each a physics step through the colored-solver kernel,
  the instances posed on the device, the sun's cascades through the BVH
  ray kernel, the raster, blur and tonemap kernels, TAA fed by the
  previous frame's camera);
* self-colliding locomotion (`entry(self_collision=True)`: the ragdoll's
  collider pairs through the pair narrowphase, one colored-solver launch per
  step, no fused launch) at 4096 envs, the slider zoo (every joint kind and
  all six pair functions) at 4096 scenes, and examples/stack_drop.py's
  scene at 4096 scenes for 400 steps;
* runtime physics, plain PyTorch with no kernel of its own: BASELINE
  config 1 (`entry.stack_drop_entry`: 1,000 boxes and spheres x 8 scenes,
  sweep-and-prune broadphase, split-Jacobi, 300 frames, then one frame of
  runtime Gauss-Seidel on the settled piles) and config 4
  (`entry.vehicle_entry`: the gear-train vehicle x 8, cylinders through
  GJK, split-Jacobi);
* terrain and cloth (`terrain_and_cloth`, last): examples/showcase.py's
  drop onto a 65 x 65 heightmap (`entry.terrain_entry`, 4096 scenes, 180
  frames with collision events; its terrain rows through the
  colored-solver kernel), raycasts and pokes on its piles, the
  triangle-exact ridge (1024 scenes, the colored-solver kernel), cloth
  against a sphere and a capsule (`entry.cloth_entry`, BASELINE config 3
  at 32 x 32 x 256 and 256 x 256 x 8; every rigid step one fused launch)
  and the vehicle on terrain (`entry.vehicle_terrain_entry`);

and checks what comes out.  Both solver kernels run at every team width
(8, 16 and 32 lanes per scene) and at ragged batches against their plain
versions; the default width is `solver_cuda.TEAM_WIDTH`.  Each phase prints
one line; the line before the last is a JSON summary of the kernels, the
last line `{"ok": true, "device": {...}}`.  Any failure exits non-zero.

    python3 chip_smoke.py
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

BATCH = 4096
MAIN_STEPS = 120
UNFUSED_STEPS = MAIN_STEPS
STAND_STEPS = 60
WARM_STEPS = 20
PLAIN_STEPS = 3
PROFILE_STEPS = 10
ITERATIONS = 30
# Kernel vs plain after one 30-iteration solve.  nvcc contracts a*b+c into
# FMA and the plain version rounds every product, and the two differ in
# op order; those rounding differences pass through 30 sweeps of ~300
# dependent row solves, with clamps that can switch.  The fused kernel also
# computes its prep in other op orders; the same bounds hold it, and its obs
# and reward are held at OBS_TOL.
VEL_TOL = 1e-3
OMEGA_TOL = 5e-3
OBS_TOL = 1e-3
# Positions and rotations move by those velocity errors times one 1/60 s
# step (1.7e-5 and 4.2e-5).
POSE_TOL = 1e-4
# `done` (head height < 1 m) may flip only where the height is this close
# to 1 m.
DONE_BAND = 1e-4
# Ragged batches of both solver kernels against their plain versions: with
# warp-sized blocks of 32 / W teams, 999 leaves the last block's last teams
# masked at W = 8 and 16 (1000 fills every block).
RAGGED = (1000, 999)
BODY_FIELDS = ("pos", "rot", "vel", "omega", "force", "torque")
# Card against the CPU path, obs and reward over a few whole env steps: the
# same rounding differences, plus the torch CUDA and CPU op implementations,
# grown through each step's 30 sweeps.
REF_STEPS = 5
REF_TOL = 1e-3

# Path tracing: 1080p frames of the atrium at depth 3.
PT_W, PT_H, PT_DEPTH = 1920, 1080, 3
PT_FRAMES = 3
RAY_SUBSET = 16384
BVH_REPS = 20
# The brute-force kernel tests every row: one 1080p launch over the atrium
# takes seconds, so it is timed over fewer launches there.
BRUTE_REPS = {"atrium": 2, "grid": 3, "small": 20}
# The ray kernels round every operation of the plane test as the plain
# version does (csrc/ray_plane.cuh), so they agree bit for bit: no ray may
# differ except at an edge (|min(u, v, 1-u-v)| <= EDGE_EPS) or a tie in t
# (within TIE_EPS relative), and t may differ by MAX_DT_REL on the others.
EDGE_EPS = 1e-5
TIE_EPS = 1e-6
MAX_DT_REL = 1e-6
# The shading kernels (csrc/pt_shade.cu) against the plain version on the
# main path's profiled frame, from one generator state: at most SHADE_SHARE
# of the pixels may differ by more than SHADE_PIXEL_TOL (relative above 1).
SHADE_PIXEL_TOL = 1e-3
SHADE_SHARE = 1e-3
# Card against CPU over the slice (64x48, depth 3): one flipped hit changes a
# whole path, so pixels are compared one by one.
SLICE_W, SLICE_H = 64, 48
SLICE_PIXEL_TOL = 1e-3
SLICE_SHARE = 0.99
SLICE_MEAN_TOL = 1e-3

# The raster frame: raster_entry at 1920x1080 (bench_raster_frame's
# configuration), one warm frame, then the best of RASTER_RUNS runs of
# RASTER_FRAMES frames.
RASTER_W, RASTER_H = 1920, 1080
RASTER_RUNS, RASTER_FRAMES = 3, 5
RASTER_REPS = 20
# The profiler keeps only the device activities whose times fall inside its
# session's window on the host's clock (kineto's outOfRange filter), so a
# few ms of skew between the two clocks drops the edges of a session, and
# all of a session of a few ms: each session's work sits between two host
# pauses of PROFILE_PAD_S.
PROFILE_PAD_S = 0.05
IMAGE_REPS = 50
# The blur's calls in one frame: HBAO (half res, 1 channel), the five bloom
# levels (3 channels), sharpen (full res, sigma 1).
BLUR_SHAPES = (((540, 960, 1), 1.5), ((1080, 1920, 3), 1.5),
               ((540, 960, 3), 1.5), ((270, 480, 3), 1.5),
               ((135, 240, 3), 1.5), ((67, 120, 3), 1.5),
               ((1080, 1920, 3), 1.0))
# The sRGB encode calls expf / logf; PyTorch's exp / log may differ by an
# ulp of the result (<= 1): 2 ulps of 1.0.
SRGB_TOL = 2.4e-7
# Card against CPU over the raster slice: 99% of pixels within
# SLICE_PIXEL_TOL and the mean below this (the CPU tests' bounds against
# JAX, tests/test_torch_pipeline.py).
SLICE_RW, SLICE_RH = 128, 64
RASTER_MEAN_TOL = 1e-4

# The roofline constants and bound helpers live in the package
# (`core/profiling.py`), where tools/torch_perf_report.py reads them too.
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from d3d12renderer_tpu_torch.core import profiling  # noqa: E402
from d3d12renderer_tpu_torch.core.profiling import (  # noqa: E402
    FP32_FLOP_PER_S, RASTER_PAIR_FLOP, bound, group_bound, solve_flop)

# Collider pairs and sliders: the self-colliding ragdoll through entry, the
# slider zoo and the stack drop, each at BATCH scenes.
SC_STEPS = 60
ZOO_STEPS = 120
STACK_STEPS = 400
# The zoo's carriage is driven into its upper limit; after ZOO_STEPS its
# travel along the axis stays within the limits by this much (the limit row
# is a Baumgarte-stabilised inequality, so it rests a little past them).
ZOO_LIMIT_TOL = 0.02
# examples/stack_drop.py's pass criterion (the heights it prints as
# expected): boxes at ~0.5 / 1.5 / 2.5 m, the sphere at ~0.4 m, within this.
STACK_HEIGHTS = (0.5, 1.5, 2.5, 0.4)
STACK_TOL = 0.05

# Runtime physics (no kernel of its own: plain PyTorch on the card, as the
# JAX package runs it in XLA).  BASELINE config 1 through stack_drop_entry:
# 1,000 bodies x 8 scenes for 300 frames of 1/60 s, checked every
# PHYS_CHECK_EVERY frames (the clock paused): heights above STACK_1K_FLOOR
# and |pos| under STACK_1K_BOUND (examples/stack_drop_1k.py's asserts),
# active rows within the 3,072 budget, and no sweep overflow at rest.  Each
# check prints the piles' state (mean speed, mean height, sweep overflow):
# they are still spreading at frame 400 (mean speed 0.20 m/s), so no check
# before frame 300 finds them at rest and the run is not cut.  Then
# the settled piles go on for STACK_GS_STEPS frames in runtime_gs mode (128
# colors x 30 iterations x 2 substeps of eager row solves a frame, 30-50 s
# on the card), as tools/jax_stack_drop_reference.py runs them on the CPU
# (GS_FRAMES): there the port's mean height stays within 2.8e-4 m of the
# split-Jacobi rest and its lowest body rises by at most 4.4e-3 m in three
# frames (at 32 colors the piles fly apart: +4.9 m in one frame).  After
# each frame the mean must stay within GS_MEAN_DRIFT and the lowest height
# within GS_MIN_DRIFT of split-Jacobi's.
# BASELINE config 4 through vehicle_entry: 8 scenes in one launch stream,
# one throttle per scene (VEHICLE_THROTTLES); the rate and the distance
# driven over the first VEHICLE_STEPS frames (every scene intact then), and
# tests/test_vehicle.py's checks: the scenes at throttle 0 after
# VEHICLE_REST_STEPS frames (intact, the chassis within 1 m of the origin
# in x-z), those at throttle 8 after VEHICLE_DRIVE_STEPS (intact, motor gear
# above 2 rad/s, drive axis above 0.3).
STACK_1K_BODIES, STACK_1K_BATCH, STACK_1K_STEPS = 1000, 8, 300
# One frame: the check's bounds after it are those of three (the reference
# tool's CPU readings cover frame 1), and each frame costs 30-50 s.
STACK_GS_STEPS = 1
GS_MEAN_DRIFT, GS_MIN_DRIFT = 5e-3, 2e-2
PHYS_CHECK_EVERY = 25
PHYS_PROFILE_STEPS = 1
STACK_1K_FLOOR, STACK_1K_BOUND = -0.2, 100.0
VEHICLE_BATCH = 8
VEHICLE_STEPS, VEHICLE_REST_STEPS, VEHICLE_DRIVE_STEPS = 100, 120, 180
VEHICLE_THROTTLES = (10.0,) * 4 + (8.0,) * 2 + (0.0,) * 2

# Terrain, events, raycasts and cloth (run last).  examples/showcase.py's
# drop through terrain_entry: TERRAIN_BATCH scenes, TERRAIN_FRAMES frames of
# 1/60 s (2 substeps, one colored-solver launch each) with collision events;
# every body ends at least TERRAIN_CLEARANCE above the bilinear surface
# under it (its half extent less 5 cm), and every body of every scene has a
# terrain-row begin event faster than IMPACT_SPEED (showcase's audio
# threshold).  The ridge (terrain_entry(scene="ridge"), triangle-exact):
# RIDGE_BATCH scenes, RIDGE_FRAMES frames, the box above RIDGE_FLOOR at
# every frame (the vertex-only narrowphase sinks it to ~1.45).  Cloth
# (cloth_entry, BASELINE config 3) at each CLOTH_RUNS (grid, scenes) for
# CLOTH_FRAMES frames: the top row pinned, the cloth at least
# CLOTH_CLEARANCE from the sphere's centre every 20 frames, the ball past
# x = 0.5 at the end (tests/test_cloth.py:126-128).  The vehicle on terrain
# (vehicle_terrain_entry) for VT_FRAMES frames.  Card against the CPU: the
# drop's first TERRAIN_REF_SCENES scenes for TERRAIN_REF_FRAMES frames from
# the run's state after frame TERRAIN_REF_FROM, the cloth's first scenes for
# CLOTH_REF_FRAMES frames, at REF_TOL.
TERRAIN_BATCH, TERRAIN_FRAMES = 4096, 180
TERRAIN_CLEARANCE = 0.45 - 0.05
IMPACT_SPEED = 0.8
# The box lands on the crest at about frame 19; the ridge runs 24 frames
# (of a planned 30) and the vehicle 5 (of 10), to keep these phases within
# 100 s (108 s at the full counts on an H100).
RIDGE_BATCH, RIDGE_FRAMES, RIDGE_FLOOR = 1024, 24, 1.95
CLOTH_RUNS = ((32, 256), (256, 8))
CLOTH_FRAMES = 240
CLOTH_CLEARANCE = 0.4 - 0.08
VT_FRAMES = 5
TERRAIN_REF_SCENES, TERRAIN_REF_FRAMES, CLOTH_REF_FRAMES = 4, 3, 5
# Every body has landed by then (the highest falls 5.5 m: ~64 frames).
TERRAIN_REF_FROM = 90

# Training: train_entry at BASELINE config 5 (BASELINE.md:163): 4096 envs,
# rollout 32 (its defaults); the median of TRAIN_ITERS iterations after a
# warm one; the eval render of examples/train_locomotion.py:109-121.
# The distributed phase: `distributed_entry` at world size 1 (NCCL), the
# sharded checkpoint round trip, and `pathtrace_sharded` of the atrium at
# 1080p, depth 1, 1 spp.
DIST_SEED = 3
SHARDED_DEPTH = 1
# The raster-options phase: the two new entries at 1080p, best of 3 x 5
# frames; each option's effect on a frame against the same frame without
# it; each entry's frame on the card against the CPU over a 256x144
# version of the scene (the raster slice's 1,294 triangles, maps cut to
# 64^2); the three modes of `render_mode` at 1080p.
OPT_W, OPT_H = 1920, 1080
OPT_SLICE_W, OPT_SLICE_H = 256, 144
OPT_SLICE_MAPS = 64
OPT_JITTER = (0.3, 0.6)
# Where an option shows: at least this many pixels change by more than
# SLICE_PIXEL_TOL against the frame without it.
OPT_MIN_PIXELS = 500
MODE_SPP = 8
# The showcase-world phase: showcase_world_entry at OPT_W x OPT_H (the
# drop's frames at batch 1, two colored launches a frame), the raster
# phases' frame counts and OPT_MIN_PIXELS.  The committed examples/data/
# studio.hdr is assets.envmap's demo map at 128 rows: its peak is the
# circumsolar glow (8.31), the 0.53-degree sun disc (1,800) falling between
# texel centres 1.4 degrees apart.  The cubemap samples the equirect's
# nearest texels, so its peak must be the equirect's own (and above 1, HDR
# beyond the LDR range).  Card
# against CPU: the world at OPT_SLICE_W x OPT_SLICE_H cut to WORLD_SLICE
# (a 17 x 17 map and 8 x 8 blades, ~2,900 triangles: the CPU's plain RT
# reflections take ~20 s a frame over 5,200 and ~47 over the full world's
# 16,852; 2 physics frames, the bodies still in the air, since 180 frames
# of a chaotic drop part the two devices' piles; maps OPT_SLICE_MAPS^2).
WORLD_SLICE = dict(resolution=17, grass_per_side=8, physics_frames=2,
                   sun_resolution=OPT_SLICE_MAPS,
                   spot_resolution=OPT_SLICE_MAPS,
                   point_resolution=OPT_SLICE_MAPS,
                   atlas_size=4 * OPT_SLICE_MAPS)
# The flythrough phase: flythrough_entry at OPT_W x OPT_H,
# FLY_SETTLE_FRAMES frames of physics alone (the pile lands on the plane
# from frame ~30), then FLY_FRAMES filmed frames (the first of them warm);
# every launch of the raster, tonemap, blur and ray kernels in the last
# filmed frame held bit-equal to its plain version on that frame's own
# inputs (the ray kernel's t and tri as check_rays holds them), and the
# solver kernel against its plain version on one substep of the settled
# pile, which must have active contact rows.
FLY_FRAMES = 16
FLY_SETTLE_FRAMES = 60
# The characters phase: character_entry at OPT_W x OPT_H (16 skinned
# characters, the raster's group path with its occlusion feedback), one
# warm frame, CHAR_FRAMES consecutive frames at seeded jitters (each held
# against the pair path on its own BVH), the best of RASTER_RUNS x
# CHAR_FRAMES frames, a profiled and a staged frame; the overlays change at
# least CHAR_MIN_PIXELS pixels; the group kernel against its plain version
# on the first frame's tables, with and without feedback; card against CPU
# at OPT_SLICE_W x OPT_SLICE_H over the raster slice's meshes with
# CHAR_SLICE_CROWD coarse characters (570 triangles each: the full ones'
# sub-pixel triangles put 1.7% of that frame's pixels off the CPU's, their
# float32 planes rounding otherwise on the two devices; the coarse ones'
# 2-pixel triangles still 0.8%, so the mean error is held to the path
# tracer's slice bound, SLICE_MEAN_TOL, not the raster frame's) and
# OPT_SLICE_MAPS^2 cascades; the fitted
# ragdolls dropped through character_ragdoll_entry for CHAR_DROP_FRAMES
# frames at CHAR_DROP_BATCH scenes: every body finite, above CHAR_FLOOR and
# within CHAR_BOUND of the origin (tests/test_ragdoll_from_skeleton.py:
# 171-175).  A stale feedback comes from CHAR_STALE_EYE.
CHAR_FRAMES = 8
CHAR_MIN_PIXELS = 200
CHAR_SLICE_CROWD = 4
CHAR_DROP_BATCH, CHAR_DROP_FRAMES = 4096, 120
CHAR_FLOOR, CHAR_BOUND = -0.5, 10.0
CHAR_STALE_EYE, CHAR_STALE_TARGET = (-6.0, 4.0, -17.0), (-2.0, 1.0, -9.0)
# The world's audio (showcase_world_entry(audio=...), examples/showcase.py
# --audio): the streamed WAV within AUDIO_TOL of the mixdown's, sample for
# sample (tests/test_audio_stream.py:37's bound), after PCM16 on both.
AUDIO_TOL = 1e-4
# The editor phase: editor_entry at tools/scene_viewer.py's defaults (size
# 256, 4 views, spp 6, recursion 2) with EDITOR_PLAY_FRAMES play frames
# (each rendered at one sample, as tests/test_scene_viewer.py's session).
# Its panels against a CPU run of the same functions at
# tests/test_torch_pipeline.py's G-buffer bounds (hit and object id differ
# on at most EDITOR_EDGE_SHARE of the pixels; normals and depth within
# EDITOR_FIELD_TOL relative on all but EDITOR_EDGE_SHARE of the pixels both
# hit alike) and its frame bounds for AO (SLICE_PIXEL_TOL on SLICE_SHARE of
# the pixels, mean below RASTER_MEAN_TOL).  Every dynamic body's lowest
# collider point at least EDITOR_FLOOR above the plane after play; one play
# frame through the kernel against the plain solve at the physics tests'
# bars (pos/rot 5e-6, vel 5e-5, omega 5e-4).
EDITOR_SIZE, EDITOR_PLAY_FRAMES = 256, 120
EDITOR_EDGE_SHARE = 2e-3
EDITOR_FIELD_TOL = 1e-4
EDITOR_FLOOR = -0.02
EDITOR_BARS = {"pos": 5e-6, "rot": 5e-6, "vel": 5e-5, "omega": 5e-4}
TRAIN_ENVS, TRAIN_ROLLOUT = 4096, 32
TRAIN_ITERS = 3
EVAL_SIZE, EVAL_SPP = 256, 8
EVAL_EYE, EVAL_TARGET = (4.0, 2.5, 5.0), (0.0, 0.9, 0.0)


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def ptxas_entries(log: str, name: str) -> list:
    """Registers, stack and spills of every kernel whose mangled name holds
    `name` (one per template instance), from nvcc's `-Xptxas -v` output."""
    lines = log.splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and name in line:
            mangled = line.split("'")[1] if "'" in line else line
            props = " ".join(l.strip() for l in lines[i + 1:i + 4]
                             if "stack frame" in l or "registers" in l)
            out.append(f"{mangled}: {props}")
    if not out:
        fail(f"ptxas output has no entry function {name}")
    return out


def ptxas_summary(log: str, name: str) -> str:
    """Registers, stack and spills of the kernel whose mangled name holds
    `name`, from nvcc's `-Xptxas -v` output."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and name in line:
            props = " ".join(l.strip() for l in lines[i + 1:i + 4]
                             if "stack frame" in l or "registers" in l)
            return f"{name}: {props}"
    fail(f"ptxas output has no entry function {name}")


def demo_scene(mesh):
    """examples/render_scene.py's scene with ico spheres of subdivision 2:
    1,678 triangles, more than one 1024-row chunk."""
    import math

    return [
        (mesh.quad(half=30.0), 0),
        (mesh.ico_sphere(1.0, 2).transformed(translate=(0, 1.0, 0)), 1),
        (mesh.ico_sphere(0.8, 2).transformed(translate=(-2.2, 0.8, 0.6)), 2),
        (mesh.box((0.7, 0.7, 0.7)).transformed(
            translate=(2.2, 0.7, -0.5),
            rotate=(0.0, math.sin(0.3), 0.0, math.cos(0.3))), 3),
        (mesh.torus(0.9, 0.3).transformed(translate=(0.8, 0.3, 2.2)), 4),
    ]


class RecordingSampler:
    """Wraps a sampler and keeps a CPU copy of every draw, in order."""

    def __init__(self, inner):
        self.inner, self.draws = inner, []

    def _keep(self, x):
        self.draws.append(x.cpu())
        return x

    def uniform(self, shape):
        return self._keep(self.inner.uniform(shape))

    def normal(self, shape):
        return self._keep(self.inner.normal(shape))

    def randint(self, shape, high):
        return self._keep(self.inner.randint(shape, high))


class ReplaySampler:
    """Hands out recorded draws in order, checking their shapes."""

    def __init__(self, draws):
        self.draws = list(draws)

    def _next(self, shape):
        x = self.draws.pop(0)
        if tuple(x.shape) != tuple(shape):
            fail(f"replayed draw of shape {tuple(x.shape)} for {shape}")
        return x

    def uniform(self, shape):
        return self._next(shape)

    def normal(self, shape):
        return self._next(shape)

    def randint(self, shape, high):
        return self._next(shape)


def chain_scene(builder):
    """`models/scenes.add_chain`: a kinematic anchor and four bodies
    (sphere, box, sphere, box) on the ground plane, jointed distance ->
    ball -> fixed -> hinge: the colored solver's row kinds 3-5 and the fused
    kernel's distance, ball and fixed preps."""
    from d3d12renderer_tpu_torch.models import scenes

    scenes.add_chain(builder)
    return builder.finalize(device="cuda")


def bounces(b, o, d, gen):
    """Rays from the primary hits of (o, d) in BVH `b`, cosine-distributed
    about the geometric normal that faces the ray, drawn from `gen`."""
    import math

    import torch

    from d3d12renderer_tpu_torch.core import maths as m
    from d3d12renderer_tpu_torch.render import bvh as bvh_mod

    res = bvh_mod.closest_hit(b, o, d)
    hit = res["hit"]
    tri = res["tri"][hit].long()
    gn = m.noz(m.cross(b.tri_e1[tri], b.tri_e2[tri]))
    gn = torch.where((torch.sum(gn * d[hit], -1) > 0)[:, None], -gn, gn)
    p = o[hit] + d[hit] * res["t"][hit][:, None] + gn * 1e-3
    u1, u2 = torch.rand((2, p.shape[0]), generator=gen, device=o.device)
    t1, t2 = m.orthonormal_basis(gn)
    l = (t1 * (u1.sqrt() * torch.cos(2 * math.pi * u2))[:, None]
         + t2 * (u1.sqrt() * torch.sin(2 * math.pi * u2))[:, None]
         + gn * (1 - u1).sqrt()[:, None])
    return p.contiguous(), m.noz(l).contiguous()


def at_margin(planes, o, d, tm):
    """Rays (a few) with a row at an edge or a tie in t, from the
    all-pairs test in float64."""
    import torch

    p = planes.double()
    out = []
    for i in range(0, o.shape[0], 64):
        oo, dd = o[i:i + 64].double(), d[i:i + 64].double()
        t = (p[:, 3] - oo @ p[:, 0:3].T) / (dd @ p[:, 0:3].T)
        u = oo @ p[:, 4:7].T + p[:, 7] + t * (dd @ p[:, 4:7].T)
        v = oo @ p[:, 8:11].T + p[:, 11] + t * (dd @ p[:, 8:11].T)
        inside = torch.minimum(torch.minimum(u, v), 1 - (u + v))
        window = ((t >= 1e-4 * (1 - TIE_EPS))
                  & (t <= tm[i:i + 64].double()[:, None] * (1 + TIE_EPS)))
        edge = ((inside.abs() <= EDGE_EPS) & window).any(1)
        acc = torch.where((inside >= -EDGE_EPS) & window, t, torch.inf)
        two = acc.topk(2, dim=1, largest=False).values
        out.append(edge | (two[:, 1] - two[:, 0] <= TIE_EPS * two[:, 0]))
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.bool,
                                                   device=o.device)


def check_rays(name, got, want, planes, o, d, tm, any_hit):
    """(mismatches, mismatches outside the margins, max |dt| relative,
    max |dt|) of one kernel's (t, tri) against the plain version's."""
    import torch

    (t, tri), (wt, wtri) = got, want
    bad = ((tri >= 0) != (wtri >= 0)) if any_hit else (tri != wtri)
    n_bad = int(bad.sum())
    if n_bad > 4096:
        fail(f"{name}: {n_bad} rays disagree with the plain version")
    idx = torch.nonzero(bad)[:, 0]
    outside = int((~at_margin(planes, o[idx], d[idx], tm[idx])).sum())
    same = ~bad & (wtri >= 0)
    if any_hit or not bool(same.any()):
        return n_bad, outside, 0.0, 0.0
    dt = (t[same] - wt[same]).abs()
    return (n_bad, outside, (dt / wt[same].abs()).max().item(),
            dt.max().item())


def path_tracing(card, cuda_ms):
    """The path-tracing phases: the BVHs, both ray kernels against the plain
    version and their times at 1080p, the atrium main path, the brute-force
    path, the card against the CPU.  Returns the kernels line's entries of
    the two ray kernels and the shading kernels."""
    import math

    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from d3d12renderer_tpu_torch.entry import pathtrace_entry
    from d3d12renderer_tpu_torch.ops import pt_shade
    from d3d12renderer_tpu_torch.ops import ray_trace as rt
    from d3d12renderer_tpu_torch.render import bvh as bvh_mod
    from d3d12renderer_tpu_torch.render import camera as cam_mod
    from d3d12renderer_tpu_torch.render import lights as lights_mod
    from d3d12renderer_tpu_torch.render import mesh
    from d3d12renderer_tpu_torch.render import pathtracer as pt

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    bvh_k, brute_k = rt.ray_closest_hit_bvh, rt.ray_closest_hit_brute
    shade_hit_k, shade_next_k = pt_shade.shade_hit, pt_shade.shade_next
    gen = torch.Generator(device=dev).manual_seed(11)

    # 9. BVHs of the two benchmark scenes.
    def depth(b):
        count = b.node_count.cpu().numpy()
        miss = b.node_miss.cpu().numpy()
        level = np.zeros(count.shape[0], np.int64)
        for i in np.nonzero(count == 0)[0]:
            level[i + 1] = level[miss[i + 1]] = level[i] + 1
        return int(level.max()) + 1

    scenes, notes = {}, []
    small_meshes = [(mesh.quad(5.0), 0), (mesh.ico_sphere(1.0, 2).transformed(
        translate=(0, 1.0, 0)), 1)]
    for name, meshes in (("atrium", mesh.atrium_scene(1.4)),
                         ("grid", mesh.sphere_grid_scene(16, 26)),
                         ("small", small_meshes)):
        t0 = time.perf_counter()
        b = bvh_mod.build_bvh(meshes, device=dev)
        rt.kernel_tables(b)
        sync()
        secs = time.perf_counter() - t0
        scenes[name] = b
        notes.append(f"{name} {int(b.tri_valid.sum())} tris in {len(meshes)} "
                     f"parts: {secs:.2f} s, {b.node_min.shape[0]} nodes, "
                     f"depth {depth(b)}")
    if int(scenes["atrium"].tri_valid.sum()) != 256_798:
        fail("the atrium does not have 256,798 triangles")
    print(f"BVH (native builder + dense tables, on the card): "
          f"{' | '.join(notes)}", flush=True)

    # 10. Both ray kernels against the plain all-pairs version on the card.
    def wavefront(eye, target):
        camera = cam_mod.look_at(eye, target, device=dev,
                                 v_fov=math.radians(60), aspect=PT_W / PT_H)
        o, d = cam_mod.generate_rays(camera, PT_W, PT_H)
        perm = torch.as_tensor(pt._tile_perm(PT_W, PT_H)[0], device=dev)
        return o[perm].contiguous(), d[perm].contiguous()

    full = {}
    for name, eye, target in (("atrium", (8.0, 6.0, -14.0), (0.0, 3.0, 0.0)),
                              ("grid", (0.0, 4.0, -10.0), (0.0, 0.5, 0.0)),
                              ("small", (0.0, 2.5, 6.0), (0.0, 1.0, 0.0))):
        o, d = wavefront(eye, target)
        full[name, "primary"] = (o, d)
        full[name, "bounce"] = bounces(scenes[name], o, d, gen)

    lines, max_dt = [], {"bvh": 0.0, "brute": 0.0}
    planes, nodes = rt.kernel_tables(scenes["atrium"])
    for wf in ("primary", "bounce"):
        o, d = full["atrium", wf]
        idx = torch.arange(0, o.shape[0], o.shape[0] // RAY_SUBSET,
                           device=dev)[:RAY_SUBSET]
        o, d = o[idx].contiguous(), d[idx].contiguous()
        for mode in ("closest", "any"):
            any_hit = mode == "any"
            tm = (torch.rand(o.shape[0], generator=gen, device=dev) * 19.5
                  + 0.5 if any_hit else torch.full((o.shape[0],), 1e30,
                                                   device=dev))
            want = rt.closest_hit_plain(planes, o, d, tm)
            for kname, got in (
                    ("bvh", bvh_k(planes, nodes, o, d, tm, any_hit)),
                    ("brute", brute_k(planes, o, d, tm, any_hit))):
                n_bad, outside, dt_rel, dt_abs = check_rays(
                    kname, got, want, planes, o, d, tm, any_hit)
                max_dt[kname] = max(max_dt[kname], dt_abs)
                lines.append(f"{kname} {wf} {mode}: {n_bad} differ "
                             f"({outside} outside margins), max |dt| rel "
                             f"{dt_rel:.2e}")
                if outside or dt_rel > MAX_DT_REL:
                    fail(f"{kname} disagrees with the plain version "
                         f"({wf}, {mode})")
            hits = int((want[1] >= 0).sum())
            lines[-1] += f" [{hits} of {o.shape[0]} rays hit]"
    splanes = rt.kernel_tables(scenes["small"])[0]
    for wf, mode in ((wf, mode) for wf in ("primary", "bounce")
                     for mode in ("closest", "any")):
        o, d = full["small", wf]
        any_hit = mode == "any"
        tm = (torch.rand(o.shape[0], generator=gen, device=dev) * 6 + 0.5
              if any_hit else torch.full((o.shape[0],), 1e30, device=dev))
        want = rt.closest_hit_plain(splanes, o, d, tm)
        n_bad, outside, dt_rel, dt_abs = check_rays(
            "brute", brute_k(splanes, o, d, tm, any_hit), want, splanes, o,
            d, tm, any_hit)
        max_dt["brute"] = max(max_dt["brute"], dt_abs)
        lines.append(f"brute small 1080p {wf} {mode}: {n_bad} differ "
                     f"({outside} outside margins), max |dt| rel "
                     f"{dt_rel:.2e}")
        if outside or dt_rel > MAX_DT_REL:
            fail(f"brute disagrees with the plain version (small, {wf}, "
                 f"{mode})")
    print(f"ray kernels vs plain on the card ({RAY_SUBSET} rays strided from "
          f"each atrium 1080p wavefront; all 1080p rays on the "
          f"{int(scenes['small'].tri_valid.sum())}-tri scene): "
          f"{'; '.join(lines)} | bounds: none outside |min(u,v,1-u-v)| <= "
          f"{EDGE_EPS} or a t tie within {TIE_EPS}, |dt| rel <= "
          f"{MAX_DT_REL}", flush=True)

    # Times at 1080p (CUDA events, after a warm launch) and the work each
    # launch did, for the bounds.
    def work(fn):
        stats = torch.zeros(2, dtype=torch.int64, device=dev)
        fn(stats)
        sync()
        tests, boxes = stats.tolist()
        return tests, boxes

    # The launches share one error word, read after each timing: no host
    # sync between the timed launches.
    times, err = [], rt.new_error_word(dev)
    for (name, wf), (o, d) in full.items():
        planes, nodes = rt.kernel_tables(scenes[name])
        tm = torch.full((o.shape[0],), 1e30, device=dev)
        # Distinct origins, bit for bit (a pinhole camera's wavefront: 1).
        origins = torch.unique(o.view(torch.int32), dim=0).shape[0]
        entry = [f"{name} {wf} ({o.shape[0]} rays, {origins} origins)"]
        for kname in ("bvh", "brute"):
            if kname == "bvh" and name == "small":
                continue
            reps = BVH_REPS if kname == "bvh" else BRUTE_REPS[name]
            if kname == "bvh":
                def fn(stats=None):
                    return bvh_k(planes, nodes, o, d, tm, stats=stats,
                                 error=err)
            else:
                def fn(stats=None):
                    return brute_k(planes, o, d, tm, stats=stats, error=err)
            ms = cuda_ms(fn, reps)
            rt.raise_on_error(err)
            tests, boxes = work(fn)
            times.append((name, wf, kname, ms, tests, boxes, o.shape[0],
                          origins))
            entry.append(f"{kname} {ms:.3f} ms ({o.shape[0] / ms / 1e3:.1f} "
                         f"Mrays/s, {reps} launches, {tests / o.shape[0]:.1f} "
                         f"plane tests and {boxes / o.shape[0]:.1f} box "
                         f"tests per ray)")
        print(f"ray kernel times at 1080p: {' | '.join(entry)} | {card}",
              flush=True)

    def ray_bound(name, rays, tests, boxes, origins):
        """The walk's plane and box tests, each origin-only term counted
        once per (origin, row or node) where rays share origins."""
        b = scenes[name]
        return profiling.ray_bound(rays, tests, boxes, origins,
                                   b.dense.n.shape[0], b.node_min.shape[0],
                                   rt.PLANE_COLS, rt.NODE_COLS)

    def kernel_time(name, wf, kname):
        for t in times:
            if t[:3] == (name, wf, kname):
                return t
        fail(f"no time for {kname} on {name} {wf}")

    # The plain version at the kernels' main-path shapes, once each: the
    # BVH kernel's (the atrium's primary wavefront) and the brute-force
    # kernel's (the small scene's).
    plain = {}
    for name, kname in (("atrium", "bvh"), ("small", "brute")):
        o, d = full[name, "primary"]
        planes, nodes = rt.kernel_tables(scenes[name])
        tm = torch.full((o.shape[0],), 1e30, device=dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = rt.closest_hit_plain(planes, o, d, tm)
        end.record()
        sync()
        got = (bvh_k(planes, nodes, o, d, tm) if kname == "bvh"
               else brute_k(planes, o, d, tm))
        n_bad, outside, dt_rel, dt_abs = check_rays(kname, got, want, planes, o,
                                               d, tm, False)
        if outside or dt_rel > MAX_DT_REL:
            fail(f"{kname} disagrees with the plain version on all of "
                 f"{name}'s primary rays")
        max_dt[kname] = max(max_dt[kname], dt_abs)
        plain[kname] = start.elapsed_time(end)
        print(f"plain version on {name}'s 1080p primary wavefront: "
              f"{plain[kname]:.1f} ms (one run); {kname} kernel vs plain "
              f"there: {n_bad} differ ({outside} outside margins), max |dt| "
              f"rel {dt_rel:.2e}", flush=True)

    # 11. The path tracer's main path: pathtrace_entry at 1920x1080, depth
    # 3, sun NEE + MIS; every ray query through the BVH kernel.
    def frames(fn, args, count):
        fn(*args)                                       # warm frame
        sync()
        bvh_k.launches = brute_k.launches = 0
        shade_hit_k.launches = shade_next_k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        rays = []
        t0 = time.perf_counter()
        for _ in range(count):
            img, n = fn(*args)
            rays.append(n)
        sync()
        secs = time.perf_counter() - t0
        rays = [int(n) for n in rays]
        if img.shape != (PT_H, PT_W, 3) or not bool(torch.isfinite(img).all()):
            fail("the frame is not a finite 1080p image")
        if not img.mean().item() > 0:
            fail("the frame is black")
        return (img, rays, 1e3 * secs / count, sum(rays) / secs / 1e6,
                (bvh_k.launches, brute_k.launches),
                (shade_hit_k.launches, shade_next_k.launches),
                torch.cuda.max_memory_allocated() / 2**30)

    fn, args = pathtrace_entry(width=PT_W, height=PT_H,
                               recursion_depth=PT_DEPTH)
    img, rays, frame_ms, mrays, (n_bvh, n_brute), n_shade, peak = frames(
        fn, args, PT_FRAMES)
    if n_bvh == 0 or n_brute:
        fail(f"main path: {n_bvh} BVH and {n_brute} brute-force launches in "
             f"{PT_FRAMES} frames")
    # Each shading kernel once a bounce: PT_DEPTH + 1 bounces a frame.
    if n_shade != ((PT_DEPTH + 1) * PT_FRAMES,) * 2:
        fail(f"main path: {n_shade} pt_shade_hit / pt_shade_next launches "
             f"in {PT_FRAMES} frames of {PT_DEPTH + 1} bounces, want one "
             f"each a bounce")
    pt_launches = n_bvh
    # The profiled frame's generator state: the frame is shaded again below
    # through the plain version from it.
    state = args[2].generator.get_state()
    with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        k_img, k_rays = fn(*args)
        sync()
        prof_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    ray_ms = sum(e.time_range.elapsed_us() for e in kernels
                 if "ray_closest_hit" in e.name) / 1e3
    bvh_events = [e for e in kernels if "ray_closest_hit_bvh" in e.name]
    bvh_frame_ms = sum(e.time_range.elapsed_us() for e in bvh_events) / 1e3
    # The bounce regroup, which every query of bounces 1-3 runs (6 of the
    # frame's 8): one closest-hit query over the atrium's 1080p bounce
    # wavefront with and without it, in turns; and its sort key alone.
    bo, bd = full["atrium", "bounce"]
    err = rt.new_error_word(dev)

    def bounce_query(regroup):
        return lambda: bvh_mod.closest_hit(scenes["atrium"], bo, bd,
                                           regroup=regroup, error=err)

    rg_ms = {True: [], False: []}
    for regroup in (True, False, False, True):
        rg_ms[regroup].append(cuda_ms(bounce_query(regroup), BVH_REPS))
    rt.raise_on_error(err)
    perm_ms = cuda_ms(lambda: rt.regroup_perm(
        bo, bd, *scenes["atrium"].cache["regroup_bounds"]), BVH_REPS)
    print(f"path trace main path (pathtrace_entry: atrium "
          f"{int(scenes['atrium'].tri_valid.sum())} tris, {PT_W}x{PT_H}, "
          f"depth {PT_DEPTH}, spp 1, sun NEE + MIS): {PT_FRAMES} frames, "
          f"rays_traced {rays}, {frame_ms:.1f} ms per frame, "
          f"{mrays:.2f} Mrays/s end to end, BVH-kernel launches per frame "
          f"{n_bvh / PT_FRAMES:.1f} (brute {n_brute}), pt_shade_hit / "
          f"pt_shade_next {n_shade[0] / PT_FRAMES:g} / "
          f"{n_shade[1] / PT_FRAMES:g}, peak memory "
          f"{peak:.2f} GiB, image mean {img.mean().item():.4f} | profiler, "
          f"one frame: {len(kernels)} kernels, device busy {dev_ms:.1f} of "
          f"{prof_ms:.1f} ms ({100 * dev_ms / prof_ms:.1f}%), ray kernels "
          f"{ray_ms:.1f} ms ({100 * ray_ms / dev_ms:.1f}% of device time), "
          f"BVH kernel {bvh_frame_ms:.3f} ms per frame in "
          f"{len(bvh_events)} launches | "
          f"bounce regroup, one closest-hit query over the atrium's "
          f"{bo.shape[0]} bounce rays, ms on {rg_ms[True]} / off "
          f"{rg_ms[False]} (in turns on, off, off, on), regroup_perm alone "
          f"{perm_ms:.3f} ms | {card}", flush=True)
    shade = shade_both_ways(fn, args, state, k_img, k_rays, kernels, card)
    shade["launches"] = sum(n_shade)
    del args

    # 12. The brute-force kernel's path: the same path tracer on the
    # 322-triangle scene (one chunk) at 1920x1080.
    small = pt.Scene(
        bvh=scenes["small"],
        materials=pt.Materials(
            albedo=torch.tensor([[0.5, 0.5, 0.5], [0.8, 0.2, 0.1]],
                                device=dev),
            emissive=torch.zeros((2, 3), device=dev),
            roughness=torch.tensor([0.7, 0.3], device=dev),
            metallic=torch.tensor([0.0, 0.0], device=dev)),
        sky=pt.default_sky(device=dev)).with_shading_table()
    small_cam = cam_mod.look_at((0.0, 2.5, 6.0), (0.0, 1.0, 0.0), device=dev,
                                v_fov=math.radians(60), aspect=PT_W / PT_H)
    settings = pt.PathTracerSettings(recursion_depth=PT_DEPTH)
    sampler = pt.Sampler(torch.Generator(device=dev).manual_seed(2))

    def small_frame(scene, camera, sampler):
        with torch.inference_mode():
            return pt.render(scene, camera, PT_W, PT_H, settings, 1, sampler)

    _, s_rays, s_ms, s_mrays, (s_bvh, s_brute), s_shade, _ = frames(
        small_frame, (small, small_cam, sampler), 1)
    if s_brute == 0 or s_bvh:
        fail(f"small-scene path: {s_bvh} BVH and {s_brute} brute-force "
             "launches")
    if s_shade != (PT_DEPTH + 1,) * 2:
        fail(f"small-scene path: {s_shade} pt_shade_hit / pt_shade_next "
             f"launches in a frame of {PT_DEPTH + 1} bounces")
    shade["launches"] += sum(s_shade)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        small_frame(small, small_cam, sampler)
        sync()
    brute_events = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                    if e.device_type == DeviceType.CUDA
                    and "ray_closest_hit_brute" in e.name]
    print(f"brute-force path (path tracer on the "
          f"{int(scenes['small'].tri_valid.sum())}-tri scene, {PT_W}x{PT_H}, "
          f"depth {PT_DEPTH}): one frame, rays_traced {s_rays[0]}, "
          f"{s_ms:.1f} ms, {s_mrays:.2f} Mrays/s, brute-force launches "
          f"{s_brute} (BVH {s_bvh}), pt_shade_hit / pt_shade_next "
          f"{s_shade[0]} / {s_shade[1]} | profiler, one frame: brute-force "
          f"kernel {sum(brute_events):.3f} ms in {len(brute_events)} "
          f"launches ({', '.join(f'{x:.3f}' for x in brute_events)}) | "
          f"{card}", flush=True)

    # 13. The card against the CPU over the whole slice: the card's draws
    # replayed into the CPU path (plain ray version), a 1,678-tri scene with
    # two point lights at 64x48, depth 3.
    def demo(device):
        return pt.Scene(
            bvh=bvh_mod.build_bvh(demo_scene(mesh), device=device),
            materials=pt.Materials(
                albedo=torch.tensor([[0.45, 0.45, 0.45], [0.75, 0.15, 0.12],
                                     [0.95, 0.93, 0.88], [0.15, 0.3, 0.75],
                                     [0.2, 0.7, 0.3]], device=device),
                emissive=torch.zeros((5, 3), device=device),
                roughness=torch.tensor([0.7, 0.35, 0.12, 0.5, 0.4],
                                       device=device),
                metallic=torch.tensor([0.0, 0.0, 1.0, 0.0, 0.0],
                                      device=device)),
            sky=pt.default_sky(device=device),
            point_lights=lights_mod.make_point_lights(
                [[-1.0, 2.5, 2.0], [2.8, 2.0, 1.5]],
                [[9000.0, 7000.0, 4000.0], [2000.0, 4000.0, 9000.0]],
                [18.0, 18.0], device=device)).with_shading_table()

    def demo_cam(device):
        return cam_mod.look_at((6, 3.2, 7), (0, 0.8, 0), device=device,
                               v_fov=math.radians(45),
                               aspect=SLICE_W / SLICE_H)

    rec = RecordingSampler(pt.Sampler(
        torch.Generator(device=dev).manual_seed(5)))
    bvh_k.launches = 0
    with torch.inference_mode():
        g_img, g_rays = pt.render(demo(dev), demo_cam(dev), SLICE_W, SLICE_H,
                                  settings, 1, rec)
        sync()
        if bvh_k.launches == 0:
            fail("the card's slice run launched no BVH kernel")
        c_img, c_rays = pt.render(demo("cpu"), demo_cam("cpu"), SLICE_W,
                                  SLICE_H, settings, 1,
                                  ReplaySampler(rec.draws))
    err = (g_img.cpu() - c_img).abs()
    close = (err <= SLICE_PIXEL_TOL * (1 + c_img.abs())).all(-1)
    share, mean_err = close.float().mean().item(), err.mean().item()
    print(f"card vs CPU over the slice ({SLICE_W}x{SLICE_H}, depth "
          f"{PT_DEPTH}, 1,678 tris, 2 point lights, the card's draws "
          f"replayed on the CPU): {100 * share:.2f}% of pixels within "
          f"{SLICE_PIXEL_TOL} abs + rel (bound {100 * SLICE_SHARE:.0f}%), "
          f"mean abs error {mean_err:.2e} (bound {SLICE_MEAN_TOL}), "
          f"rays_traced {int(g_rays)} (card) / {int(c_rays)} (CPU)",
          flush=True)
    if share < SLICE_SHARE or not mean_err < SLICE_MEAN_TOL:
        fail("the card's frame disagrees with the CPU path")

    bvh_t = kernel_time("atrium", "primary", "bvh")
    brute_t = kernel_time("small", "primary", "brute")
    entries = []
    for kname, t, launches, replaces in (
            ("bvh", bvh_t, pt_launches,
             "d3d12renderer_tpu/ops/ray_trace_pallas.py:333"),
            ("brute", brute_t, s_brute,
             "d3d12renderer_tpu/ops/ray_trace_pallas.py:157")):
        name, _, _, ms, tests, boxes, rays_n, origins = t
        b_ms, b_by = ray_bound(name, rays_n, tests, boxes, origins)
        entries.append({
            "name": f"ray_closest_hit_{kname}", "route": "cuda",
            "source": "d3d12renderer_tpu_torch/csrc/ray_trace.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_dt[kname], "ms": ms, "plain_ms": plain[kname],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    return entries + [shade]


def shade_both_ways(fn, args, state, k_img, k_rays, kernels, card):
    """The main path's profiled frame (`k_img`, `k_rays`, its profiler
    `kernels`) shaded again through the plain halves
    (`pathtracer.shade_hit_plain` / `shade_next_plain`) from its generator
    `state`: the share of pixels off by more than SHADE_PIXEL_TOL, the two
    kernels' device ms a launch beside their bound (the bytes they need,
    counted from the frame's own inputs bounce by bounce: a dead row at its
    masks alone), the plain halves' ms by CUDA events, ptxas.  Returns the
    kernels line's entry, its launches left to the caller."""
    import torch

    from d3d12renderer_tpu_torch import cuda_build
    from d3d12renderer_tpu_torch.render import pathtracer as pt

    scene, sampler = args[0], args[2]
    atlas = scene.materials.texture_atlas is not None
    timed, work = [], []
    plain = {"hit": pt.shade_hit_plain, "next": pt.shade_next_plain}

    def events(kind):
        def call(*a):
            if kind == "hit":
                # (tri, rays, rows alive at the bounce's start, first,
                # draws); the count stays on the device until the end.
                rays, first = a[2].shape[0], a[9]
                live = rays if first else a[4].sum()
                work.append((a[1]["tri"], rays, live, first, a[7]))
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = plain[kind](*a)
            end.record()
            timed.append((start, end))
            return out
        return call

    halves = events("hit"), events("next")
    shaders = pt.shaders
    sampler.generator.set_state(state)
    pt.shaders = lambda device: halves
    try:
        p_img, p_rays = fn(*args)
    finally:
        pt.shaders = shaders
    torch.cuda.synchronize()
    bounces = len(work)
    plain_ms = sum(s.elapsed_time(e) for s, e in timed) / bounces
    lives = [int(w[2]) for w in work]
    work = [profiling.shade_bytes(
        rays, live, int(torch.unique(tri[tri >= 0]).numel()), first,
        draws.brdf is None, draws.sun is not None, draws.light is not None,
        atlas, draws.roulette is not None)
        for (tri, rays, _, first, draws), live in zip(work, lives)]
    diff = (k_img - p_img).abs()
    off = (diff > SHADE_PIXEL_TOL * torch.clamp(p_img.abs(), min=1.0)).any(-1)
    share = float(off.float().mean())
    ms = {name: [e.time_range.elapsed_us() / 1e3 for e in kernels
                 if name in e.name] for name in ("pt_shade_hit",
                                                 "pt_shade_next")}
    if any(len(v) != bounces for v in ms.values()):
        fail(f"the profiled frame shows {[len(v) for v in ms.values()]} "
             f"shading launches for {bounces} bounces")
    hit_bytes = sum(w[0] for w in work)
    next_bytes = sum(w[1] for w in work)
    bounds = [profiling.bound(b, 0)[0] for b in (hit_bytes, next_bytes)]
    kernel_ms = (sum(ms["pt_shade_hit"]) + sum(ms["pt_shade_next"])) / bounces
    bound_ms = sum(bounds) / bounces
    log = (cuda_build.build_dir() / "build.log").read_text()
    print(f"shading (ops/pt_shade.py) on the main path's profiled frame, "
          f"kernels vs plain from one generator state: "
          f"{100 * share:.4f}% of pixels off by more than {SHADE_PIXEL_TOL} "
          f"(bound {100 * SHADE_SHARE:.2f}%), max abs diff "
          f"{float(diff.max()):.3e}, rays_traced {int(k_rays)} / "
          f"{int(p_rays)} | rows alive at each bounce's start "
          f"{', '.join(str(x) for x in lives)} | device ms a launch: "
          f"pt_shade_hit "
          f"{', '.join(f'{x:.4f}' for x in ms['pt_shade_hit'])} (bound "
          f"{bounds[0] / bounces:.4f} a bounce, {hit_bytes / bounces / 1e6:.1f}"
          f" MB), pt_shade_next "
          f"{', '.join(f'{x:.4f}' for x in ms['pt_shade_next'])} (bound "
          f"{bounds[1] / bounces:.4f}, {next_bytes / bounces / 1e6:.1f} MB); "
          f"a bounce {kernel_ms:.4f} ms, {100 * bound_ms / kernel_ms:.1f}% of "
          f"its bound; the plain halves {plain_ms:.3f} ms a bounce (events) | "
          + " | ".join(ptxas_entries(log, "pt_shade_hit")
                       + ptxas_entries(log, "pt_shade_next"))
          + f" | {card}", flush=True)
    if share > SHADE_SHARE or int(k_rays) != int(p_rays):
        fail("the shading kernels disagree with the plain version")
    return {"name": "pt_shade", "route": "cuda",
            "source": "d3d12renderer_tpu_torch/csrc/pt_shade.cu",
            "replaces": "none (XLA's fusion of "
                        "d3d12renderer_tpu/render/pathtracer.py trace_sample)",
            "launches": 0, "max_abs_err": float(diff.max()),
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None}


def slice_meshes(mesh):
    """The raster tests' meshes (tests/test_torch_pipeline.py): ground, an
    ico sphere, a box; 1,294 triangles."""
    return [(mesh.quad(half=20.0), 0),
            (mesh.ico_sphere(1.0, 3).transformed(translate=(0, 1.0, 0)), 1),
            (mesh.box((0.7, 0.7, 0.7)).transformed(
                translate=(2.2, 0.7, -0.5)), 2)]


def slice_scene(mesh, pt, device):
    """The raster tests' scene (tests/test_torch_pipeline.py): ground, a
    metal ico sphere, an emissive box; 1,294 triangles."""
    import torch

    from d3d12renderer_tpu_torch.render import bvh as bvh_mod

    meshes = slice_meshes(mesh)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    return pt.Scene(
        bvh=bvh_mod.build_bvh(meshes, device=device),
        materials=pt.Materials(
            albedo=f32([[0.5, 0.5, 0.5], [0.8, 0.2, 0.2], [0.2, 0.4, 0.8]]),
            emissive=f32([[0, 0, 0], [0, 0, 0], [0.4, 0.2, 0.0]]),
            roughness=f32([0.8, 0.3, 0.6]), metallic=f32([0.0, 1.0, 0.0])),
        sky=pt.default_sky(device=device)).with_shading_table()


def raster_frame(card, cuda_ms):
    """The raster frame's phases: the raster kernel against its plain
    version on the atrium at 1080p, the blur and tonemap kernels at the
    frame's shapes, their times, the main path through `raster_entry`, a
    profiled frame and its stage times, the card against the CPU.  Returns
    the three kernels' entries of the kernels line."""
    import math

    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType

    from d3d12renderer_tpu_torch.entry import raster_entry
    from d3d12renderer_tpu_torch.ops import image, raster
    from d3d12renderer_tpu_torch.render import bvh as bvh_mod
    from d3d12renderer_tpu_torch.render import camera as cam_mod
    from d3d12renderer_tpu_torch.render import mesh
    from d3d12renderer_tpu_torch.render import pathtracer as pt
    from d3d12renderer_tpu_torch.render import pipeline, post

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    raster_k, blur_k, tonemap_k = (raster.rasterize_tiles, image.gaussian_blur,
                                   image.tonemap)

    def once_ms(fn):
        """One run by CUDA events (the plain versions)."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        sync()
        start.record()
        out = fn()
        end.record()
        sync()
        return start.elapsed_time(end), out

    # 14. The raster kernel against its plain version: the atrium at
    # 1920x1080 (padded to 1920x1088), a fixed jitter.
    b = bvh_mod.build_bvh(mesh.atrium_scene(1.4), device=dev)
    tris = int(b.tri_valid.sum())
    cam = cam_mod.look_at((8.0, 6.0, -14.0), (0.0, 3.0, 0.0), device=dev,
                          v_fov=math.radians(60), aspect=RASTER_W / RASTER_H)
    wp = RASTER_W + (-RASTER_W) % raster.TILE_X
    hp = RASTER_H + (-RASTER_H) % raster.TILE_Y
    jitter = torch.tensor([0.3, 0.7], device=dev)
    mat, attr = raster.perspective_rows(cam, RASTER_W, RASTER_H)
    planes, rect, q_tri = raster.project_planes(
        b.tri_v0, b.tri_e1, b.tri_e2, b.tri_valid, mat, attr, wp, hp)
    pair_tri, seg = raster.bin_pairs(rect, q_tri, wp, hp)
    pairs = int(seg[-1])
    per_tile = (seg[1:] - seg[:-1]).to(torch.float32)
    args = (planes, pair_tri, seg, jitter, wp, hp)
    got = raster_k(*args)
    sync()
    plain_ms = {}
    plain_ms["raster"], want = once_ms(lambda: raster.rasterize_plain(*args))
    same = [torch.equal(a, c) for a, c in zip(got, want)]
    raster_err = max((a.float() - c.float()).abs().max().item()
                     for a, c in zip(got, want))
    hit_share = (want[1] >= 0).float().mean().item()
    full = raster.closest_hit_raster(b, cam, RASTER_W, RASTER_H, jitter=jitter)
    overflow = int(full["overflow"])
    # The cull's work and its bound, both from the plain version's output.
    # A plane's largest q over a band is its q at one corner sample (as
    # raster.cu computes it); no winning q may exceed that of its own plane
    # in its band.  The (pair, band) tests that any exact cull must run are
    # those whose largest q exceeds the band's least final q: the kernel's
    # bound counts these, not the kernel's own work, which it must cover.
    work = torch.zeros(2, dtype=torch.int64, device=dev)
    raster_k(*args, stats=work)
    tested, culled = work.tolist()
    rows = raster.TILE_Y // raster.BANDS

    pix = torch.nonzero(want[1] >= 0)[:, 0]
    above_own = int((want[0][pix] > profiling.pair_band_q(
        raster, planes[want[1][pix].long(), 9:12],
        (pix % wp) // raster.TILE_X * raster.TILE_X,
        (pix // wp) // rows * rows, jitter)).sum())
    needed = profiling.pair_tests_needed(raster, planes, pair_tri, seg,
                                         want[0], jitter, wp, hp)
    print(f"raster kernel vs plain (atrium {tris} tris, {RASTER_W}x{RASTER_H} "
          f"padded to {wp}x{hp}, jitter (0.3, 0.7), {raster.BANDS} blocks per "
          f"tile): q/tri/u/v bit-equal {same}, max |diff| {raster_err:.3e}, "
          f"{pairs} pairs over {seg.shape[0] - 1} tiles "
          f"({per_tile.mean().item():.1f} mean, {int(per_tile.max().item())} "
          f"max per tile), {100 * hit_share:.1f}% of pixels hit, overflow "
          f"{overflow} | cull: {tested} (pair, band) tests, {culled} culled, "
          f"{100 * tested / (tested + culled):.2f}% of the {pairs} pairs x "
          f"{raster.BANDS} bands tested; {needed} "
          f"({100 * needed / (tested + culled):.2f}%) that any exact cull "
          f"of a band must test | winners above the largest q of their "
          f"plane in their band: {above_own} of {pix.shape[0]} (must be 0)",
          flush=True)
    if not all(same) or overflow:
        fail("the raster kernel disagrees with its plain version")
    if above_own or not tested + culled == pairs * raster.BANDS \
            or not needed <= tested < pairs * raster.BANDS:
        fail("the raster kernel's cull bound or work count is wrong")

    # 15. The blur at the frame's seven shapes and the tonemap at 1080p,
    # both against their plain versions; the library blur (replicate pad +
    # two depthwise 1-D convolutions) timed beside the blur kernel.  `ms` is
    # CUDA events over back-to-back calls, which at the small shapes time
    # the host's work per call (longer than the card's); `device_ms` is the
    # profiler's device time of the call's own kernels, each call after a
    # write of twice the L2 (cold L2: no input left there by the call
    # before); `warm_ms` the same with a one-float write between calls.
    l2_flush = torch.empty(2 * torch.cuda.get_device_properties(
        dev).L2_cache_size // 4, device=dev)
    marker = torch.zeros(1, device=dev)
    separators = {"cold": l2_flush.zero_, "warm": lambda: marker.add_(1.0)}

    def kernel_events(fn):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            fn()
            sync()
            time.sleep(PROFILE_PAD_S)
        return sorted((e for e in prof.events()
                       if e.device_type == DeviceType.CUDA),
                      key=lambda e: e.time_range.start)

    def separator_names(sep):
        names = {e.name for e in kernel_events(
            lambda: [sep() for _ in range(4 * IMAGE_REPS)])}
        if not names:
            fail("the profiler saw none of the separators' kernels")
        return names

    sep_names = {k: separator_names(v) for k, v in separators.items()}

    def device_ms(fn, reps):
        """{cold, warm}: device ms per call of fn's kernels, the mean over
        the calls the profiler saw whole (a separator on either side: it
        may miss the first or last kernels of a session)."""
        out = {}
        for kind, sep in separators.items():
            def run():
                for _ in range(reps):
                    sep()
                    fn()
                sep()

            calls, cur, events = [], None, kernel_events(run)
            for e in events:
                if e.name in sep_names[kind]:
                    if cur:
                        calls.append(cur)
                    cur = []
                elif cur is not None:
                    cur.append(e.time_range.elapsed_us())
            sizes = [len(c) for c in calls]
            whole = [c for c in calls
                     if sizes and len(c) == max(set(sizes), key=sizes.count)]
            if len(whole) < reps // 2:
                fail(f"the profiler saw {len(whole)} of {reps} timed calls "
                     f"whole ({kind}; {len(events)} kernels in the session)")
            out[kind] = sum(map(sum, whole)) / len(whole) / 1e3
        return out["cold"], out["warm"]

    gen = torch.Generator(device=dev).manual_seed(12)
    blur_rows, blur = [], {"ms": 0.0, "device_ms": 0.0, "warm_ms": 0.0,
                           "plain_ms": 0.0, "library_ms": 0.0,
                           "library_device_ms": 0.0, "library_warm_ms": 0.0,
                           "bytes": 0, "flop": 0, "err": 0.0}
    for shape, sigma in BLUR_SHAPES:
        x = torch.rand(shape, generator=gen, device=dev) * 4
        taps = image.gaussian_kernel(sigma)
        r = taps.shape[0] // 2
        ms = cuda_ms(lambda: blur_k(x, taps), IMAGE_REPS)
        dev_ms, warm_ms = device_ms(lambda: blur_k(x, taps), IMAGE_REPS)
        p_ms, want = once_ms(lambda: image.blur_plain(x, taps.to(dev)))
        got = blur_k(x, taps)
        err = (got - want).abs().max().item()
        if not torch.equal(got, want):
            fail(f"the blur kernel disagrees with its plain version at "
                 f"{shape} (max |diff| {err:.3e})")
        c = shape[2]
        x4 = x.permute(2, 0, 1)[None].contiguous()
        wv = taps.to(dev).reshape(1, 1, -1, 1).expand(c, 1, -1, 1).contiguous()
        wh = taps.to(dev).reshape(1, 1, 1, -1).expand(c, 1, 1, -1).contiguous()

        def library():
            y = F.pad(x4, (r, r, r, r), mode="replicate")
            return F.conv2d(F.conv2d(y, wv, groups=c), wh, groups=c)

        lib_ms = cuda_ms(library, IMAGE_REPS)
        lib_dev_ms, lib_warm_ms = device_ms(library, IMAGE_REPS)
        lib_err = (library()[0].permute(1, 2, 0) - got).abs().max().item()
        if not lib_err < 1e-5:
            fail(f"the library blur does not compute the blur ({lib_err:.3e})")
        blur["ms"] += ms
        blur["device_ms"] += dev_ms
        blur["plain_ms"] += p_ms
        blur["library_ms"] += lib_ms
        blur["library_device_ms"] += lib_dev_ms
        work = profiling.blur_work(x.numel(), r)
        blur["bytes"] += work[0]
        blur["flop"] += work[1]
        blur["err"] = max(blur["err"], err)
        blur["warm_ms"] += warm_ms
        blur["library_warm_ms"] += lib_warm_ms
        blur_rows.append(f"{shape} sigma {sigma}: {ms:.4f} ms (device, cold "
                         f"L2 {dev_ms:.4f}, warm {warm_ms:.4f}), plain "
                         f"{p_ms:.3f}, library {lib_ms:.4f} (device, cold L2 "
                         f"{lib_dev_ms:.4f}, warm {lib_warm_ms:.4f})")
    # The tonemap at 1080p RGB, and on a view at offset 1 (not 16-byte
    # aligned) and an odd length of the same floats, both encodes.
    n = RASTER_W * RASTER_H * 3
    flat = torch.rand(n + 8, generator=gen, device=dev) * 20
    x = flat[:n].view(RASTER_H, RASTER_W, 3)
    settings = post.TonemapSettings()
    consts = image.tonemap_constants(settings)
    tone = {}
    for srgb in (False, True):
        for xs in (flat[1:n + 1], flat[3:n - 2]):
            got = tonemap_k(xs, settings, srgb)
            want = image.tonemap_plain(xs, consts, srgb)
            err = (got - want).abs().max().item()
            if not (torch.equal(got, want) if not srgb else err <= SRGB_TOL):
                fail(f"the tonemap kernel disagrees with its plain version "
                     f"on {xs.numel()} floats at offset "
                     f"{xs.storage_offset()} (srgb={srgb}, max |diff| "
                     f"{err:.3e})")
        got = tonemap_k(x, settings, srgb)
        p_ms, want = once_ms(lambda: image.tonemap_plain(x, consts, srgb))
        err = (got - want).abs().max().item()
        ok = torch.equal(got, want) if not srgb else err <= SRGB_TOL
        if not ok:
            fail(f"the tonemap kernel disagrees with its plain version "
                 f"(srgb={srgb}, max |diff| {err:.3e})")
        tone[srgb] = (cuda_ms(lambda: tonemap_k(x, settings, srgb),
                              IMAGE_REPS), p_ms, err)
    # The wrapper's host time per call: the host clock around calls that
    # the card runs behind it (no synchronisation inside).
    sync()
    t0 = time.perf_counter()
    for _ in range(IMAGE_REPS):
        tonemap_k(x, settings)
    tone_host_ms = 1e3 * (time.perf_counter() - t0) / IMAGE_REPS
    sync()
    tone_dev_ms, tone_warm_ms = device_ms(lambda: tonemap_k(x, settings),
                                          IMAGE_REPS)
    print(f"blur kernel vs plain at the frame's 7 shapes: bit-equal | "
          f"{' | '.join(blur_rows)} | the frame's 7: kernel "
          f"{blur['ms']:.4f} ms (device, cold L2 {blur['device_ms']:.4f}, "
          f"warm {blur['warm_ms']:.4f}), plain {blur['plain_ms']:.3f} ms, "
          f"library {blur['library_ms']:.4f} ms (device, cold L2 "
          f"{blur['library_device_ms']:.4f}, warm "
          f"{blur['library_warm_ms']:.4f}) | tonemap kernel vs plain at "
          f"{RASTER_W}x{RASTER_H}x3 (and at offset 1 and an odd length): "
          f"sRGB off bit-equal, {tone[False][0]:.4f} ms by events (device, "
          f"cold L2 {tone_dev_ms:.4f}, warm {tone_warm_ms:.4f}; the "
          f"wrapper's host time {tone_host_ms:.4f} ms per call) "
          f"(plain {tone[False][1]:.3f}); sRGB on max |diff| "
          f"{tone[True][2]:.2e} (bound {SRGB_TOL}: CUDA's expf / logf against "
          f"PyTorch's), {tone[True][0]:.4f} ms | {card}", flush=True)

    # Kernel times at the path's shapes (CUDA events), the binning beside.
    raster_ms = cuda_ms(lambda: raster_k(*args), RASTER_REPS)
    bin_ms = cuda_ms(lambda: raster.bin_pairs(rect, q_tri, wp, hp),
                     RASTER_REPS)
    query_ms = cuda_ms(lambda: raster.closest_hit_raster(
        b, cam, RASTER_W, RASTER_H, jitter=jitter), RASTER_REPS)
    print(f"raster kernel {raster_ms:.3f} ms per 1080p frame ({RASTER_REPS} "
          f"launches; plain version {plain_ms['raster']:.1f} ms, one run); "
          f"binning {bin_ms:.3f} ms; closest_hit_raster (projection, "
          f"binning with its host read of the pair count, kernel, t) "
          f"{query_ms:.3f} ms | {card}", flush=True)
    del got, want, full

    # 16. The main path: raster_entry at 1920x1080 (the atrium, raster
    # primary, half-res effects, 3 sun cascades at 512^2 rendered once).
    t0 = time.perf_counter()
    fn, state = raster_entry(device=dev, width=RASTER_W, height=RASTER_H)
    sync()
    setup_s = time.perf_counter() - t0
    ldr, state, aux = fn(state)                         # warm frame
    sync()
    raster_k.launches = blur_k.launches = tonemap_k.launches = 0
    best = math.inf
    for _ in range(RASTER_RUNS):
        t0 = time.perf_counter()
        for _ in range(RASTER_FRAMES):
            ldr, state, aux = fn(state)
        sync()
        best = min(best, (time.perf_counter() - t0) / RASTER_FRAMES)
    frames = RASTER_RUNS * RASTER_FRAMES
    launches = {"raster": raster_k.launches, "blur": blur_k.launches,
                "tonemap": tonemap_k.launches}
    frame_ms = 1e3 * best
    gb = aux["gbuffer"]
    if ldr.shape != (RASTER_H, RASTER_W, 3) or not bool(
            torch.isfinite(ldr).all()):
        fail("the raster frame is not a finite 1080p image")
    if int(gb.overflow) != 0:
        fail("the raster frame dropped pairs")
    want_launches = {"raster": frames, "blur": 7 * frames, "tonemap": frames}
    if launches != want_launches:
        fail(f"raster main path: launches {launches} in {frames} frames, want "
             f"{want_launches}")
    mean = ldr.mean().item()
    if not 0.0 < mean < 1.0:
        fail(f"the raster frame's mean {mean} is not inside (0, 1)")
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(state)
        sync()
        prof_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    own = {k: sum(e.time_range.elapsed_us() for e in kernels if k in e.name)
           / 1e3 for k in ("raster_tiles", "gaussian_blur", "tonemap")}
    _, _, staged = fn(state, profile_stages=True)
    stages = " ".join(f"{k} {v:.2f}" for k, v in staged["stage_ms"].items())
    print(f"raster main path (raster_entry: atrium {tris} tris, "
          f"{RASTER_W}x{RASTER_H}, raster primary, half-res AO + SSR, TAA, "
          f"bloom, tonemap, sharpen; set-up with 3x512^2 shadow texels "
          f"{setup_s:.2f} s): best of {RASTER_RUNS} runs of {RASTER_FRAMES} "
          f"frames {frame_ms:.2f} ms per frame ({1e3 / frame_ms:.1f} fps), "
          f"ldr mean {mean:.4f}, {int(gb.pairs)} pairs, overflow 0, "
          f"launches per frame raster {launches['raster'] / frames:.0f} tonemap "
          f"{launches['tonemap'] / frames:.0f} blur "
          f"{launches['blur'] / frames:.0f} | profiler, one frame: "
          f"{len(kernels)} kernels, device busy {dev_ms:.1f} of {prof_ms:.1f} "
          f"ms ({100 * dev_ms / prof_ms:.1f}%), raster {own['raster_tiles']:.2f} "
          f"ms, blur {own['gaussian_blur']:.3f} ms, tonemap "
          f"{own['tonemap']:.3f} ms | stage ms (CUDA events, one frame): "
          f"{stages} | {card}", flush=True)

    # 17. The card against the CPU over the slice: the raster tests' scene
    # at 128x64, shadows at 128^2, two frames with TAA history.
    def slice_frames(device):
        scene = slice_scene(mesh, pt, device)
        camera = cam_mod.look_at((5, 3, 6), (0.5, 0.8, 0), device=device,
                                 v_fov=math.radians(50),
                                 aspect=SLICE_RW / SLICE_RH)
        settings = pipeline.RendererSettings(primary="raster",
                                             half_res_effects=True)
        st = pipeline.initial_frame_state(SLICE_RW, SLICE_RH, device)
        out = []
        with torch.inference_mode():
            for jit in ((0.25, 0.6), (0.7, 0.3)):
                img, st, _ = pipeline.render_frame_with_shadows(
                    scene, camera, SLICE_RW, SLICE_RH, settings,
                    shadow_resolution=128, frame_state=st,
                    prev_camera=camera, jitter=jit)
                out.append(img.cpu())
        return out

    raster_k.launches = 0
    card_frames = slice_frames(dev)
    if raster_k.launches != 2:
        fail("the card's slice run did not go through the raster kernel")
    cpu_frames = slice_frames("cpu")
    rows = []
    for i, (g, c) in enumerate(zip(card_frames, cpu_frames)):
        err = (g - c).abs().amax(-1)
        share = (err <= SLICE_PIXEL_TOL).float().mean().item()
        rows.append((share, err.mean().item()))
        if share < SLICE_SHARE or not err.mean().item() < RASTER_MEAN_TOL:
            fail(f"the card's raster frame {i + 1} disagrees with the CPU "
                 "path")
    print(f"card vs CPU over the raster slice ({SLICE_RW}x{SLICE_RH}, 1,294 "
          f"tris, shadows 3x128^2, two frames with TAA history): "
          + "; ".join(f"frame {i + 1}: {100 * s:.2f}% of pixels within "
                      f"{SLICE_PIXEL_TOL}, mean error {m:.2e}"
                      for i, (s, m) in enumerate(rows))
          + f" (bounds {100 * SLICE_SHARE:.0f}%, {RASTER_MEAN_TOL})",
          flush=True)

    # The (pair, band) tests any exact cull must run, each over its band's
    # pixels.
    r_bound = profiling.pair_bound(raster, planes, pairs, seg, needed, wp,
                                   hp)
    b_bound = bound(blur["bytes"], blur["flop"])
    t_bound = profiling.tonemap_bound(n)
    return [{
        "name": "raster_tiles", "route": "cuda",
        "source": "d3d12renderer_tpu_torch/csrc/raster.cu",
        "replaces": "d3d12renderer_tpu/ops/raster_pallas.py:329",
        "launches": launches["raster"], "max_abs_err": raster_err,
        "ms": raster_ms, "plain_ms": plain_ms["raster"],
        "bound_ms": r_bound[0], "bound_by": r_bound[1], "library_ms": None,
    }, {
        "name": "tonemap", "route": "cuda",
        "source": "d3d12renderer_tpu_torch/csrc/image.cu",
        "replaces": "d3d12renderer_tpu/ops/pallas_kernels.py:57",
        "launches": launches["tonemap"], "max_abs_err": tone[False][2],
        "ms": tone[False][0], "device_ms": tone_dev_ms,
        "plain_ms": tone[False][1],
        "bound_ms": t_bound[0], "bound_by": t_bound[1], "library_ms": None,
    }, {
        "name": "gaussian_blur", "route": "cuda",
        "source": "d3d12renderer_tpu_torch/csrc/image.cu",
        "replaces": "d3d12renderer_tpu/ops/pallas_kernels.py:122",
        "launches": launches["blur"], "max_abs_err": blur["err"],
        "ms": blur["ms"], "device_ms": blur["device_ms"],
        "plain_ms": blur["plain_ms"],
        "bound_ms": b_bound[0], "bound_by": b_bound[1],
        "library_ms": blur["library_ms"],
        "library_device_ms": blur["library_device_ms"],
    }]


def collision_physics(card, cuda_ms, max_err):
    """Collider pairs and sliders through the colored-solver kernel: the
    self-colliding locomotion path (`entry(self_collision=True)` at BATCH
    envs, SC_STEPS steps), the slider zoo and the stack drop.  Each holds
    the kernel against its plain version on one substep's preps with active
    pair rows, at the width the wrapper picks and at every width whose block
    fits (a width that does not fit must be refused).  Returns the kernel's
    JSON fields for the self-colliding path."""
    import torch
    from torch.autograd import DeviceType

    from d3d12renderer_tpu_torch.entry import entry
    from d3d12renderer_tpu_torch.learning.loco_env import (FRAME_RATE,
                                                           STATE_SIZE, LocoEnv)
    from d3d12renderer_tpu_torch.models import ragdoll as rd
    from d3d12renderer_tpu_torch.models import scenes
    from d3d12renderer_tpu_torch.physics import (collide, solver_cuda, step,
                                                 substep_cuda)
    from d3d12renderer_tpu_torch.physics.builder import SceneBuilder
    from d3d12renderer_tpu_torch.physics.types import BodyState, PhysicsSettings

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    fused_k, colored = (substep_cuda.fused_substep_cuda,
                        solver_cuda.colored_solve_cuda)
    dt = 1.0 / FRAME_RATE

    def profiled(fn, reps):
        with torch.inference_mode(), torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            sync()
        return [e for e in prof.events() if e.device_type == DeviceType.CUDA]

    def pair_rows_active(arch, contacts):
        q = arch.vs_plane_collider.shape[0]
        return int(contacts.active[:, q:].sum())

    def check_kernel(arch, sp, what):
        """Kernel vs plain on one substep's preps.  Returns the solver, the
        kernel-only call, the plain args and a summary dict."""
        batch = sp.vel1.shape[0]
        solver = solver_cuda.ColoredSolver(arch, sp.contacts.body_a.shape[0],
                                           ITERATIONS, "kernel")
        args = (sp.joint_preps, sp.contact_prep, sp.vel1, sp.omega1)
        prep = solver.pack_prep(sp.joint_preps, sp.contact_prep, batch, dev)
        arrays = solver.kernel_arrays(dev)
        slots = sp.vel1.shape[1]

        def kernel_only(width=None):
            return colored(sp.vel1, sp.omega1, prep, arrays,
                           len(solver.tables), solver.num_impulses,
                           ITERATIONS, width)

        def floats_of(width):
            return solver_cuda.colored_team_floats(
                slots, prep.shape[1], solver.num_impulses, width)

        limit = solver_cuda.shared_limit(dev)
        picked = solver_cuda.pick_team_width(floats_of, limit)
        with torch.inference_mode():
            pv, pw = solver.plain(*args)
            before = colored.launches
            rv, rw = solver(*args)            # the route: pack + kernel
            sync()
            if colored.launches != before + 1:
                fail(f"{what}: the route did not launch the kernel once")
            errs = {"route": (max_err(rv, pv), max_err(rw, pw))}
            for width in solver_cuda.TEAM_WIDTHS:
                fits = solver_cuda.block_shared_bytes(floats_of(width),
                                                      width) <= limit
                try:
                    kv, kw = kernel_only(width)
                    sync()
                except ValueError:
                    if fits:
                        fail(f"{what}: width {width} fits but was refused")
                    errs[width] = "refused"
                    continue
                if not fits:
                    fail(f"{what}: width {width} does not fit but launched")
                if not (torch.isfinite(kv).all() and torch.isfinite(kw).all()):
                    fail(f"{what}: kernel output is not finite at width "
                         f"{width}")
                errs[width] = (max_err(kv, pv), max_err(kw, pw))
        for key, e in errs.items():
            if e != "refused" and not (e[0] <= VEL_TOL and e[1] <= OMEGA_TOL):
                fail(f"{what}: the colored kernel disagrees with its plain "
                     f"version ({key}): {e}")
        worst = max(max(e) for e in errs.values() if e != "refused")
        return solver, kernel_only, args, prep, dict(
            picked=picked, errs=errs, worst=worst,
            block=solver_cuda.block_shared_bytes(floats_of(picked), picked))

    # Self-colliding locomotion through entry: policy forward + env step.
    fn, (model, est, obs) = entry(device=dev, batch=BATCH, seed=0,
                                  self_collision=True)
    env = LocoEnv(self_collision=True, device=dev)
    if env._fused_step is not None:
        fail("the self-colliding env built a fused route")
    fn(model, est, obs)
    sync()
    fused_k.launches = colored.launches = 0
    t0 = time.perf_counter()
    with torch.inference_mode():
        finite = torch.ones((), dtype=torch.bool, device=dev)
        fell = torch.zeros(BATCH, dtype=torch.bool, device=dev)
        for _ in range(SC_STEPS):
            obs, est, reward, done = fn(model, est, obs)
            finite &= torch.isfinite(obs).all() & torch.isfinite(reward).all()
            fell |= done
    sync()
    secs = time.perf_counter() - t0
    sc_launches = (fused_k.launches, colored.launches)
    if sc_launches != (0, SC_STEPS):
        fail(f"self-colliding path: {sc_launches[0]} fused and "
             f"{sc_launches[1]} colored launches in {SC_STEPS} steps (want 0 "
             f"and {SC_STEPS})")
    b = est.bodies
    if not (bool(finite) and all(bool(torch.isfinite(x).all())
                                 for x in (b.pos, b.rot, b.vel, b.omega))):
        fail("self-colliding path: non-finite outputs")
    if obs.shape != (BATCH, STATE_SIZE) or reward.shape != (BATCH,):
        fail(f"self-colliding path: bad shapes {tuple(obs.shape)}")
    sps = BATCH * SC_STEPS / secs

    holder = [est, obs]

    def one_step():
        o, e, _, _ = fn(model, holder[0], holder[1])
        holder[0], holder[1] = e, o

    kernels = profiled(one_step, PROFILE_STEPS)
    dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 \
        / PROFILE_STEPS
    step_ms = 1e3 * BATCH / sps
    col_dev = [e for e in kernels if "colored_solver" in e.name]
    col_prof_ms = (sum(e.time_range.elapsed_us() for e in col_dev) / 1e3
                   / max(1, len(col_dev)))
    narrow_launches = len(profiled(
        lambda: collide.generate_contacts(env.arch, holder[0].bodies), 1))

    # Kernel vs plain after one solve from the state the run reached, with
    # the policy's action.  The policy's standing ragdolls seldom touch
    # themselves, so every other env is posed into contact: each part's
    # horizontal offset from the torso drawn in to 60% (the feet and toes
    # to 30%), as the CPU tests pose them.
    est, obs = holder
    with torch.inference_mode():
        mean, _, _ = model(obs)
        smoothed = est.last_action + 0.1 * (mean - est.last_action)
        bodies = est.bodies
        shrink = torch.full((bodies.pos.shape[1], 1), 0.6, device=dev)
        shrink[env.part_idx[[rd.BODY_PARTS.index(n) for n in (
            "left_foot", "right_foot", "left_toes", "right_toes")]]] = 0.3
        torso = bodies.pos[:, env.part_idx[0]][:, None, :]
        posed = bodies.pos.clone()
        posed[..., [0, 2]] = (torso[..., [0, 2]] + shrink
                              * (posed[..., [0, 2]] - torso[..., [0, 2]]))
        every_other = (torch.arange(BATCH, device=dev) % 2 == 0)[:, None, None]
        bodies = bodies.replace(pos=torch.where(every_other, posed,
                                                bodies.pos))
        sp = step.substep_prep(env.arch, bodies, dt, env.settings,
                               env._motor_overrides(smoothed))
    active = pair_rows_active(env.arch, sp.contacts)
    run_active = pair_rows_active(
        env.arch, collide.generate_contacts(env.arch, est.bodies))
    if active == 0:
        fail("self-colliding check: no pair row is active")
    solver, kernel_only, args, prep, sc = check_kernel(env.arch, sp,
                                                       "self-colliding")
    points = int(sp.contact_prep.pmask.sum().item())
    # The plain solve takes seconds here (42 color steps x 30 iterations of
    # eager gathers and scatters): one timed call after a warm one.
    with torch.inference_mode():
        kernel_ms = [cuda_ms(kernel_only, 20)]
        plain_ms = [cuda_ms(lambda: solver.plain(*args), 1)]
        kernel_ms.append(cuda_ms(kernel_only, 20))
        width_ms = {w: cuda_ms(lambda: kernel_only(w), 20)
                    for w, e in sc["errs"].items()
                    if isinstance(w, int) and e != "refused"}
    sc_bound = bound(4 * (prep.numel() + 4 * sp.vel1.numel()),
                     solve_flop(solver.tables, BATCH, points, ITERATIONS))
    print(f"self-colliding locomotion (entry(self_collision=True), {BATCH} "
          f"envs, {SC_STEPS} steps): colored launches {sc_launches[1]}, "
          f"fused {sc_launches[0]}, finite, {int(fell.sum())} envs fell | "
          f"env-steps/s {sps:.0f} | profiler over {PROFILE_STEPS} steps: "
          f"{len(kernels) / PROFILE_STEPS:.1f} kernels per step, narrowphase "
          f"{narrow_launches} launches per step, device busy {dev_ms:.3f} ms "
          f"of {step_ms:.3f} ms per step ({100 * dev_ms / step_ms:.1f}%), "
          f"colored kernel {col_prof_ms:.3f} ms per launch | kernel vs plain "
          f"after one solve (half the envs posed into contact; {active} "
          f"active pair rows, {run_active} in the run's own state, "
          f"{points} active points, width picked {sc['picked']}, "
          f"{sc['block']} B per block):"
          f" max err {json.dumps(sc['errs'])} (bounds {VEL_TOL} / "
          f"{OMEGA_TOL}) | ms per solve: kernel {kernel_ms}, by width "
          f"{json.dumps(width_ms)}, plain {plain_ms}, bound "
          f"{sc_bound[0]:.4f} ({sc_bound[1]}) | {card}",
          flush=True)

    # Slider zoo: BATCH jittered scenes, kernel vs plain at the first
    # substep (the cluster's pairs touch), then ZOO_STEPS steps.
    zb = SceneBuilder()
    info = scenes.add_slider_zoo(zb)
    zarch, z0 = zb.finalize(device=dev)
    g = torch.Generator(device=dev).manual_seed(11)
    moving = (zarch.inv_mass[:-1] > 0)[None, :, None]

    def noise(shape, scale):
        return (torch.rand(shape, generator=g, device=dev) - 0.5) * scale

    zs = BodyState(*(getattr(z0, f).expand((BATCH,) + getattr(z0, f).shape[1:])
                     .contiguous() for f in BODY_FIELDS))
    zs = zs.replace(pos=zs.pos + noise(zs.pos.shape, 0.006) * moving,
                    vel=noise(zs.vel.shape, 0.6) * moving,
                    omega=noise(zs.omega.shape, 1.0) * moving)
    zset = PhysicsSettings(frame_rate=FRAME_RATE)
    with torch.inference_mode():
        zsp = step.substep_prep(zarch, zs, dt, zset)
    z_active = pair_rows_active(zarch, zsp.contacts)
    if z_active == 0:
        fail("zoo check: no pair row is active")
    _, _, _, _, zoo = check_kernel(zarch, zsp, "slider zoo")
    fused_k.launches = colored.launches = 0
    t0 = time.perf_counter()
    with torch.inference_mode():
        for _ in range(ZOO_STEPS):
            zs, _ = step.physics_step(zarch, zs, zset, dt)
        sync()
        zsecs = time.perf_counter() - t0
        k = [t.kind for t in zarch.joints].index("slider")
        dist = step.substep_prep(zarch, zs, dt, zset).joint_preps[k]["dist"]
    if (fused_k.launches, colored.launches) != (0, ZOO_STEPS):
        fail(f"slider zoo: {fused_k.launches} fused and {colored.launches} "
             f"colored launches in {ZOO_STEPS} steps")
    if not all(bool(torch.isfinite(getattr(zs, f)).all())
               for f in ("pos", "rot", "vel", "omega")):
        fail("slider zoo: non-finite state")
    lo, hi = scenes.SLIDER_LIMITS
    d_min, d_mean, d_max = (dist.min().item(), dist.mean().item(),
                            dist.max().item())
    print(f"slider zoo ({BATCH} jittered scenes, {ZOO_STEPS} steps, "
          f"{zarch.num_contact_rows} contact rows, joints "
          f"{[t.kind for t in zarch.joints]}): colored launches "
          f"{colored.launches}, fused {fused_k.launches}, finite | kernel vs "
          f"plain at the first substep ({z_active} active pair rows, width "
          f"picked {zoo['picked']}): max err {json.dumps(zoo['errs'])} | "
          f"slider travel min/mean/max {d_min:.4f} / {d_mean:.4f} / "
          f"{d_max:.4f} (limits {lo} / {hi}, tolerance {ZOO_LIMIT_TOL}) | "
          f"{1e3 * zsecs / ZOO_STEPS:.2f} ms per step | {card}", flush=True)
    if not (d_min >= lo - ZOO_LIMIT_TOL and d_max <= hi + ZOO_LIMIT_TOL):
        fail("slider zoo: the slider left its limits")

    # Stack drop: examples/stack_drop.py's scene, its settings (120 Hz, one
    # substep per step), BATCH scenes with their x / z jittered by 1 mm.
    sb = SceneBuilder()
    scenes.add_stack_drop(sb)
    sarch, s0 = sb.finalize(device=dev)
    ss = BodyState(*(getattr(s0, f).expand((BATCH,) + getattr(s0, f).shape[1:])
                     .contiguous() for f in BODY_FIELDS))
    jitter = noise(ss.pos.shape, 0.002)
    jitter[..., 1] = 0.0
    ss = ss.replace(pos=ss.pos + jitter)
    sset = PhysicsSettings()
    h = 1.0 / sset.frame_rate
    fused_k.launches = colored.launches = 0
    t0 = time.perf_counter()
    with torch.inference_mode():
        for _ in range(STACK_STEPS):
            ss, contacts = step.physics_step(sarch, ss, sset, h, 1)
        sync()
    ssecs = time.perf_counter() - t0
    if (fused_k.launches, colored.launches) != (0, STACK_STEPS):
        fail(f"stack drop: {fused_k.launches} fused and {colored.launches} "
             f"colored launches in {STACK_STEPS} steps")
    y = ss.pos[..., 1]
    want = torch.tensor(STACK_HEIGHTS, device=dev)
    height_err = (y - want).abs().max().item()
    resting = pair_rows_active(sarch, contacts)
    with torch.inference_mode():
        ssp = step.substep_prep(sarch, ss, h, sset)
    _, _, _, _, stack = check_kernel(sarch, ssp, "stack drop")
    print(f"stack drop ({BATCH} scenes, {STACK_STEPS} steps at "
          f"{sset.frame_rate} Hz): colored launches {STACK_STEPS}, fused 0 | "
          f"heights of scene 0 {[round(v, 4) for v in y[0].tolist()]}, max "
          f"|height - {list(STACK_HEIGHTS)}| over all scenes {height_err:.4f} "
          f"(bound {STACK_TOL}), lowest {y.min().item():.4f}, {resting} "
          f"resting pair rows | kernel vs plain at rest: max err "
          f"{json.dumps(stack['errs'])} | {1e3 * ssecs / STACK_STEPS:.2f} ms "
          f"per step | {card}", flush=True)
    if not (bool(torch.isfinite(ss.pos).all()) and height_err <= STACK_TOL):
        fail("stack drop: the bodies did not come to rest at their heights")

    return {
        "launches": sc_launches[1],
        "max_abs_err": max(sc["worst"], zoo["worst"], stack["worst"]),
        "ms": min(kernel_ms),
        "plain_ms": min(plain_ms),
        "bound_ms": sc_bound[0],
        "bound_by": sc_bound[1],
    }


def runtime_physics(card):
    """BASELINE configs 1 and 4 on the card: the 1k-body stack drop
    (runtime sweep-and-prune broadphase, split-Jacobi contacts, then
    runtime Gauss-Seidel on the settled piles) and the gear-train vehicle
    (cylinders and GJK, split-Jacobi).  Each prints its rates on the host
    clock (synchronised), launches per frame and the device's busy share
    from the profiler, and fails on any check.  The entries' runner steps
    the first frame of a call eagerly and replays the next one's CUDA graph
    for every later frame; runtime_gs's single frame stays eager."""
    stack_drop_1k(card)
    vehicle(card)


def _profiled(fn, frames=PHYS_PROFILE_STEPS):
    """(kernels per frame, device ms per frame) of `fn(frames)` over
    `frames` frames."""
    import torch
    from torch.autograd import DeviceType

    with torch.inference_mode(), torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn(frames)
        torch.cuda.synchronize()
    ks = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return (len(ks) / frames,
            sum(e.time_range.elapsed_us() for e in ks) / 1e3 / frames)


def _contact_kernels(arch, st):
    """Kernels of one `collide.generate_contacts` (poses, broadphase,
    narrowphase) at state `st`: the contact layer of a substep."""
    from d3d12renderer_tpu_torch.physics import collide

    return _profiled(lambda n: collide.generate_contacts(arch, st), 1)[0]


def _finite(st):
    import torch

    return all(bool(torch.isfinite(getattr(st, f)).all())
               for f in ("pos", "rot", "vel", "omega"))


def stack_drop_1k(card):
    """BASELINE config 1 through `stack_drop_entry`, then the settled piles
    in runtime_gs mode."""
    import torch

    from d3d12renderer_tpu_torch.entry import STACK_GS_COLORS, stack_drop_entry
    from d3d12renderer_tpu_torch.physics import broadphase, collide

    sync = torch.cuda.synchronize
    profiled, finite = _profiled, _finite

    fn, (arch, st0) = stack_drop_entry(
        device="cuda", bodies=STACK_1K_BODIES, batch=STACK_1K_BATCH)
    fn(st0, 1)   # warm-up (allocator, first launches)
    sync()
    # The sweep's own overflow (a window that ended while the sweep still
    # overlapped) apart from the row cap's (more than sap_row_cap partners).
    no_cap = dataclasses.replace(arch, sap_row_cap=0)
    st, secs = st0, 0.0
    worst = dict(ymin=1e9, pos=0.0, overflow=0, capped=0, active=0)
    rest = []
    with torch.inference_mode():
        for done in range(0, STACK_1K_STEPS, PHYS_CHECK_EVERY):
            t0 = time.perf_counter()
            st, _ = fn(st, min(PHYS_CHECK_EVERY, STACK_1K_STEPS - done))
            sync()
            secs += time.perf_counter() - t0
            worst["ymin"] = min(worst["ymin"], st.pos[..., 1].min().item())
            worst["pos"] = max(worst["pos"], st.pos.abs().max().item())
            spill = broadphase.overflow_count(no_cap, st)
            worst["overflow"] = max(worst["overflow"], int(spill.max()))
            worst["capped"] = max(worst["capped"], int(
                (broadphase.overflow_count(arch, st) - spill).max()))
            worst["active"] = max(worst["active"], int(
                collide.generate_contacts(arch, st).active.sum(-1).max()))
            rest.append((min(done + PHYS_CHECK_EVERY, STACK_1K_STEPS),
                         round(st.vel.norm(dim=-1).mean().item(), 4),
                         round(st.pos[..., 1].mean().item(), 4),
                         int(spill.max())))
    print("stack drop 1k, the piles at each check (frame, mean |vel| m/s, "
          f"mean height m, sweep overflow): {rest}", flush=True)
    if not finite(st):
        fail("stack drop 1k: non-finite state")
    ys = st.pos[..., 1]
    heights = (ys.min().item(), ys.mean().item(), ys.max().item())
    sps = STACK_1K_BATCH * STACK_1K_STEPS / secs
    kpf, dev_ms = profiled(lambda n: fn(st, n))
    contact_k = _contact_kernels(arch, st)
    frame_ms = 1e3 * STACK_1K_BATCH / sps
    print(f"stack drop 1k: {STACK_1K_BODIES} bodies x {STACK_1K_BATCH} "
          f"scenes, {STACK_1K_STEPS} frames of 1/60 s (120 Hz, 30 "
          f"iterations, split_jacobi; graph replays after the first) in "
          f"{secs:.2f} s: {sps:.1f} "
          f"scene-steps/s, {sps * STACK_1K_BODIES:.0f} body-steps/s | "
          f"heights min {heights[0]:.4f} mean {heights[1]:.4f} max "
          f"{heights[2]:.4f}; over the run (every {PHYS_CHECK_EVERY} frames) "
          f"min height {worst['ymin']:.4f}, max |pos| {worst['pos']:.3f}, "
          f"sweep overflow {worst['overflow']} (at rest "
          f"{int(spill.max())}), colliders past the row cap "
          f"of {arch.sap_row_cap} at most {worst['capped']}, active rows at most "
          f"{worst['active']} of {arch.sap_active_budget} | profiler over "
          f"{PHYS_PROFILE_STEPS} frames: {kpf:.0f} kernels per frame (one "
          f"generate_contacts: {contact_k:.0f}; two per frame), device "
          f"busy {dev_ms:.3f} ms per frame of {frame_ms:.3f} ms wall "
          f"({100 * dev_ms / frame_ms:.1f}%) | {card}", flush=True)
    if not worst["ymin"] > STACK_1K_FLOOR:
        fail(f"stack drop 1k: a body sank to {worst['ymin']:.3f}")
    if not worst["pos"] < STACK_1K_BOUND:
        fail(f"stack drop 1k: |pos| reached {worst['pos']:.1f}")
    # The JAX package's own run spills the window while the pile collapses
    # (up to 14 colliders at frames 50-100, tools/jax_stack_drop_reference.py)
    # and at rest not at all: the piles at rest must not.
    if int(spill.max()) != 0:
        fail(f"stack drop 1k: sweep overflow {int(spill.max())} at rest")
    if worst["active"] > arch.sap_active_budget:
        fail(f"stack drop 1k: {worst['active']} active rows, budget "
             f"{arch.sap_active_budget}")

    # The settled piles go on in runtime Gauss-Seidel mode, frame by frame.
    gs_fn, _ = stack_drop_entry(
        device="cuda", bodies=STACK_1K_BODIES, batch=STACK_1K_BATCH,
        contact_mode="runtime_gs")
    gs_st, gs_secs, drift = st, 0.0, []
    for _ in range(STACK_GS_STEPS):
        t0 = time.perf_counter()
        gs_st, _ = gs_fn(gs_st, 1)
        sync()
        gs_secs += time.perf_counter() - t0
        if not finite(gs_st):
            fail("stack drop 1k, runtime_gs: non-finite state")
        gys = gs_st.pos[..., 1]
        drift.append((gys.min().item(), gys.mean().item()))
    print(f"stack drop 1k, runtime_gs ({STACK_GS_COLORS} colors): the "
          f"settled piles {STACK_GS_STEPS} frames more in "
          f"{gs_secs:.2f} s, {1e3 * gs_secs / STACK_GS_STEPS:.0f} ms per frame "
          f"| heights after each frame (min, mean) "
          f"{[(round(a, 4), round(b, 4)) for a, b in drift]} against "
          f"split_jacobi's ({heights[0]:.4f}, {heights[1]:.4f}): drift at "
          f"most {max(abs(b - heights[1]) for _, b in drift):.2e} m in the "
          f"mean (bound {GS_MEAN_DRIFT}), "
          f"{max(abs(a - heights[0]) for a, _ in drift):.2e} m in the lowest "
          f"(bound {GS_MIN_DRIFT}) | {card}", flush=True)
    if any(abs(b - heights[1]) > GS_MEAN_DRIFT
           or abs(a - heights[0]) > GS_MIN_DRIFT for a, b in drift):
        fail("stack drop 1k, runtime_gs: the settled piles moved")


def vehicle(card):
    """BASELINE config 4 through `vehicle_entry`, one throttle per scene in
    one launch stream, and tests/test_vehicle.py's checks on the card."""
    import torch

    from d3d12renderer_tpu_torch.entry import vehicle_entry

    sync = torch.cuda.synchronize
    profiled, finite = _profiled, _finite

    fn, (varch, info, vst0) = vehicle_entry(
        device="cuda", batch=VEHICLE_BATCH, throttle=VEHICLE_THROTTLES)
    throttle = torch.tensor(VEHICLE_THROTTLES, device=vst0.pos.device)
    fast, drive, rest = throttle == 10.0, throttle == 8.0, throttle == 0.0
    fn(vst0, 1)   # warm-up (allocator, first launches)
    sync()

    def run(vst, steps):
        vst, _ = fn(vst, steps)
        if not finite(vst):
            fail("vehicle: non-finite state")
        return vst

    def intact(vst, scenes, what):
        """tests/test_vehicle.py's assembly checks: the chassis between 0.03
        and 2 m high, every wheel within 3.5 m of it."""
        motor = vst.pos[scenes, info.bodies["motor"]]
        if not bool(((motor[:, 1] > 0.03) & (motor[:, 1] < 2.0)).all()):
            fail(f"vehicle ({what}): chassis height {motor[:, 1].tolist()}")
        for w in ("left_front_wheel", "right_front_wheel", "left_rear_wheel",
                  "right_rear_wheel"):
            gap = (vst.pos[scenes, info.bodies[w]] - motor).norm(dim=-1)
            if not bool((gap < 3.5).all()):
                fail(f"vehicle ({what}): {w} {gap.max().item():.2f} m off")
        return motor

    t0 = time.perf_counter()
    vst = run(vst0, VEHICLE_STEPS)
    sync()
    vsecs = time.perf_counter() - t0
    motor = intact(vst, slice(None), f"{VEHICLE_STEPS} frames")
    m0 = vst0.pos[:, info.bodies["motor"]]
    drove = (motor - m0)[fast][:, [0, 2]].norm(dim=-1)
    v_kpf, v_dev_ms = profiled(lambda n: fn(vst, n))
    v_contact_k = _contact_kernels(varch, vst)
    vsps = VEHICLE_BATCH * VEHICLE_STEPS / vsecs
    v_frame_ms = 1e3 * VEHICLE_BATCH / vsps
    print(f"vehicle: {VEHICLE_BATCH} scenes (throttle {VEHICLE_THROTTLES}), "
          f"{VEHICLE_STEPS} frames of 1/60 s (60 Hz, split_jacobi; graph "
          f"replays after the first) in {vsecs:.2f} s: {vsps:.1f} "
          f"scene-steps/s | at throttle 10 drove "
          f"{drove.min().item():.3f}-{drove.max().item():.3f} m, chassis "
          f"height {motor[fast, 1].mean().item():.4f} | profiler over "
          f"{PHYS_PROFILE_STEPS} frames: {v_kpf:.0f} kernels per frame (one "
          f"generate_contacts: {v_contact_k:.0f}), device "
          f"busy {v_dev_ms:.3f} ms per frame of {v_frame_ms:.3f} ms wall "
          f"({100 * v_dev_ms / v_frame_ms:.1f}%) | {card}", flush=True)

    vst = run(vst, VEHICLE_REST_STEPS - VEHICLE_STEPS)
    rmotor = intact(vst, rest, "throttle 0")
    off = rmotor[:, [0, 2]].norm(dim=-1)
    vst = run(vst, VEHICLE_DRIVE_STEPS - VEHICLE_REST_STEPS)
    dmotor = intact(vst, drive, "throttle 8")
    w_gear = vst.omega[drive, info.bodies["motor_gear"]].norm(dim=-1)
    w_drive = vst.omega[drive, info.bodies["drive_axis"]].norm(dim=-1)
    print(f"vehicle checks: at throttle 0 after {VEHICLE_REST_STEPS} frames "
          f"chassis height {rmotor[:, 1].mean().item():.4f}, x-z distance "
          f"from the origin {off.max().item():.4f} m (< 1); at throttle 8 "
          f"after {VEHICLE_DRIVE_STEPS} frames chassis height "
          f"{dmotor[:, 1].mean().item():.4f}, |omega| motor gear "
          f"{w_gear.min().item():.3f} (> 2), drive axis "
          f"{w_drive.min().item():.3f} (> 0.3) in every such scene",
          flush=True)
    if not bool((off < 1.0).all()):
        fail("vehicle: the chassis at rest drifted 1 m or more")
    if not (bool((w_gear > 2.0).all()) and bool((w_drive > 0.3).all())):
        fail("vehicle: the motor does not drive the gear train")


def terrain_and_cloth(card, cuda_ms, max_err):
    """Terrain, collision events, raycasts, pokes and cloth on the card:
    examples/showcase.py's drop (kernel #1 on terrain rows), the
    triangle-exact ridge (kernel #1), cloth against a sphere and a capsule
    (kernel #2 on the rigid steps), the vehicle on terrain (plain PyTorch)
    and `ray_cast` / `ray_poke` on the drop's piles.  Each path's launches
    are counted from 0 around its run.  Returns the kernels line's entries
    for the terrain and cloth paths."""
    import torch

    from d3d12renderer_tpu_torch.entry import (cloth_entry, terrain_entry,
                                               vehicle_terrain_entry)
    from d3d12renderer_tpu_torch.physics import (collide, events, raycast,
                                                 solver_cuda, step,
                                                 substep_cuda)
    from d3d12renderer_tpu_torch.physics.types import PhysicsSettings
    from d3d12renderer_tpu_torch.terrain.heightmap import (
        sample_height_bilinear)

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    colored, fused_k = (solver_cuda.colored_solve_cuda,
                        substep_cuda.fused_substep_cuda)
    t_phase = time.perf_counter()
    out = []

    def ground(arch, pos):
        h, _ = sample_height_bilinear(arch.terrain_height[0],
                                      arch.terrain_origin[0],
                                      arch.terrain_cell[0], pos[..., 0],
                                      pos[..., 2])
        return h

    def colored_check(arch, st, what):
        """Kernel #1 against its plain version on one substep's preps at
        the state `st`; its CUDA-event time, the plain time and the bound
        from this substep's tables and active points."""
        settings = PhysicsSettings()
        with torch.inference_mode():
            sp = step.substep_prep(arch, st, 1.0 / settings.frame_rate,
                                   settings)
            solver = solver_cuda.ColoredSolver(
                arch, sp.contacts.body_a.shape[0], ITERATIONS, "kernel")
            args = (sp.joint_preps, sp.contact_prep, sp.vel1, sp.omega1)
            kv, kw = solver(*args)
            # The plain solve takes seconds at these batches: timed once,
            # by events, on this first call.
            t_start = torch.cuda.Event(enable_timing=True)
            t_end = torch.cuda.Event(enable_timing=True)
            t_start.record()
            pv, pw = solver.plain(*args)
            t_end.record()
            sync()
            p_ms = t_start.elapsed_time(t_end)
            errs = (max_err(kv, pv), max_err(kw, pw))
            batch = sp.vel1.shape[0]
            prep = solver.pack_prep(sp.joint_preps, sp.contact_prep, batch,
                                    dev)
            arrays = solver.kernel_arrays(dev)

            def kernel_only():
                return colored(sp.vel1, sp.omega1, prep, arrays,
                               len(solver.tables), solver.num_impulses,
                               ITERATIONS)

            k_ms = cuda_ms(kernel_only, 20)
        q = arch.vs_plane_collider.shape[0]
        q2 = arch.vs_terrain_collider.shape[0]
        terrain_active = int(sp.contacts.active[:, q:q + q2].sum())
        points = int(sp.contact_prep.pmask.sum().item())
        b = bound(4 * (prep.numel() + 4 * sp.vel1.numel()),
                  solve_flop(solver.tables, batch, points, ITERATIONS))
        if terrain_active == 0:
            fail(f"{what}: no terrain row is active at the kernel check")
        if not (errs[0] <= VEL_TOL and errs[1] <= OMEGA_TOL):
            fail(f"{what}: the colored kernel disagrees with its plain "
                 f"version: {errs}")
        return dict(errs=errs, ms=k_ms, plain_ms=p_ms, bound=b,
                    terrain_active=terrain_active, points=points,
                    colors=len(arch.contact_color_indices))

    def kernel_entry(name, source, replaces, launches, chk):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(chk["errs"]), "ms": chk["ms"],
                "plain_ms": chk["plain_ms"], "bound_ms": chk["bound"][0],
                "bound_by": chk["bound"][1], "library_ms": None}


    # 1. The terrain drop with events.
    t0p = time.perf_counter()
    fn, (arch, st0) = terrain_entry(device=dev, batch=TERRAIN_BATCH)
    fn(st0)
    sync()
    q2 = arch.vs_terrain_collider.shape[0]
    q = arch.vs_plane_collider.shape[0]
    tbody = arch.vs_terrain_body
    nb = arch.num_bodies
    fast = torch.zeros((TERRAIN_BATCH, q2), dtype=torch.bool, device=dev)
    began = torch.zeros_like(fast)
    colored.launches = fused_k.launches = 0
    st, prev = st0, None
    t0 = time.perf_counter()
    for f in range(TERRAIN_FRAMES):
        st, contacts, ev = fn(st, prev)
        prev = ev.active
        tb = ev.begin[:, q:q + q2]
        began |= tb
        fast |= tb & (ev.approach_speed[:, q:q + q2] > IMPACT_SPEED)
        if f == TERRAIN_REF_FROM:
            snap = (st.replace(**{k: getattr(st, k)[:TERRAIN_REF_SCENES]
                                  .clone() for k in BODY_FIELDS}),
                    prev[:TERRAIN_REF_SCENES].clone())
    sync()
    secs = time.perf_counter() - t0
    drop_launches = (colored.launches, fused_k.launches)
    if drop_launches != (2 * TERRAIN_FRAMES, 0):
        fail(f"terrain drop: {drop_launches} colored / fused launches in "
             f"{TERRAIN_FRAMES} frames (want {2 * TERRAIN_FRAMES} and 0)")
    if not _finite(st):
        fail("terrain drop: non-finite state")
    lift = st.pos[..., 1] - ground(arch, st.pos)
    body_fast = torch.stack([fast[:, tbody == b].any(-1) for b in range(nb)],
                            -1)
    wall = 1e3 * secs / TERRAIN_FRAMES
    kpf, dev_ms = _profiled(lambda n: [fn(st) for _ in range(n)])
    drop_chk = colored_check(arch, st, "terrain drop")
    # Card against the CPU from the snapshot after the first contacts.
    cpu_fn, (cpu_arch, _) = terrain_entry(device="cpu",
                                          batch=TERRAIN_REF_SCENES)
    ref_gpu, pa_gpu = snap
    ref_cpu = ref_gpu.replace(**{k: getattr(ref_gpu, k).cpu()
                                 for k in BODY_FIELDS})
    pa_cpu = pa_gpu.cpu()
    for _ in range(TERRAIN_REF_FRAMES):
        ref_gpu, _, eg = fn(ref_gpu, pa_gpu)
        ref_cpu, _, ec = cpu_fn(ref_cpu, pa_cpu)
        pa_gpu, pa_cpu = eg.active, ec.active
    ref_err = max(max_err(getattr(ref_gpu, k).cpu(), getattr(ref_cpu, k))
                  for k in ("pos", "rot"))
    print(f"terrain drop (terrain_entry: examples/showcase.py's 65 x 65 "
          f"heightmap, {nb} bodies x {TERRAIN_BATCH} scenes, "
          f"{TERRAIN_FRAMES} frames of 2 substeps with events, "
          f"{arch.num_contact_rows} contact rows ({q2} terrain) in "
          f"{drop_chk['colors']} colors): {wall:.2f} "
          f"ms per frame, colored launches {drop_launches[0]}, fused "
          f"{drop_launches[1]} | lowest body {lift.min().item():.4f} m above "
          f"the surface under it (bound {TERRAIN_CLEARANCE}); begin events "
          f"on {int(began.any(0).sum())} of {q2} terrain rows, every body of "
          f"every scene with a begin faster than {IMPACT_SPEED} m/s: "
          f"{bool(body_fast.all())} ({int(body_fast.sum())} of "
          f"{body_fast.numel()}) | profiled frame: {kpf:.0f} kernels, device "
          f"busy {dev_ms:.3f} ms of the frame's {wall:.3f} ms "
          f"({100 * dev_ms / wall:.1f}%) | kernel #1 vs plain at the run's "
          f"end ({drop_chk['terrain_active']} active terrain rows, "
          f"{drop_chk['points']} points): max err {drop_chk['errs']} (bounds "
          f"{VEL_TOL} / {OMEGA_TOL}), {drop_chk['ms']:.4f} ms by events, "
          f"plain {drop_chk['plain_ms']:.1f} ms, bound "
          f"{drop_chk['bound'][0]:.5f} ({drop_chk['bound'][1]}) | card vs "
          f"CPU, {TERRAIN_REF_SCENES} scenes x {TERRAIN_REF_FRAMES} frames "
          f"after frame {TERRAIN_REF_FROM}: max err pos/rot {ref_err:.2e} (bound "
          f"{REF_TOL}) | {time.perf_counter() - t0p:.1f} s | {card}",
          flush=True)
    if not lift.min().item() >= TERRAIN_CLEARANCE:
        fail("terrain drop: a body sank into the terrain")
    if not bool(body_fast.all()):
        fail("terrain drop: a body has no collision-begin event faster than "
             f"{IMPACT_SPEED} m/s")
    if not ref_err <= REF_TOL:
        fail("terrain drop: the card disagrees with the CPU path")
    out.append(kernel_entry(
        "colored_solver_terrain_drop",
        "d3d12renderer_tpu_torch/csrc/colored_solver.cu",
        "d3d12renderer_tpu/physics/solver_pallas.py:619", drop_launches[0],
        drop_chk))

    # 5. Raycasts and pokes on the drop's piles (before they move on).
    t0p = time.perf_counter()
    with torch.inference_mode():
        down = torch.tensor([0.0, -1.0, 0.0], device=dev)
        up5 = torch.tensor([0.0, 5.0, 0.0], device=dev)
        ray_sub = 64
        sub = st.replace(**{k: getattr(st, k)[:ray_sub].contiguous()
                            for k in BODY_FIELDS})
        sub_cpu = sub.replace(**{k: getattr(sub, k).cpu()
                                 for k in BODY_FIELDS})
        hits, ray_err, ray_ms = [], 0.0, []
        origins = [st.pos[:, b] + up5 for b in range(nb)] + [
            torch.tensor([15.0, 20.0, 15.0], device=dev).expand(
                TERRAIN_BATCH, 3)]
        for i, o in enumerate(origins):
            t0 = time.perf_counter()
            h = raycast.ray_cast(arch, st, o, down)
            sync()
            ray_ms.append(1e3 * (time.perf_counter() - t0))
            want = i if i < nb else -1
            hits.append(float((h.body == want).float().mean()))
            hc = raycast.ray_cast(cpu_arch, sub_cpu, o[:ray_sub].cpu(),
                                  down.cpu())
            hg = raycast.ray_cast(arch, sub, o[:ray_sub], down)
            if not torch.equal(hg.hit.cpu(), hc.hit):
                fail("ray_cast: the card's hits differ from the CPU path's")
            ray_err = max(ray_err, ((hg.t.cpu() - hc.t).abs()
                                    / hc.t.abs().clamp(min=1.0))[hc.hit]
                          .max().item())
        pokes = {}
        for exact in (False, True):
            poked = events.ray_poke(arch, st.replace(
                force=torch.zeros_like(st.force),
                torque=torch.zeros_like(st.torque)), origins[0], down,
                exact=exact)
            pokes[exact] = float((poked.force[:, 0].norm(dim=-1) > 0)
                                 .float().mean())
    print(f"raycasts on the drop's piles ({TERRAIN_BATCH} scenes, one ray "
          f"per scene, straight down over each body and over open terrain): "
          f"share hitting the body below (or the terrain) "
          f"{[round(x, 4) for x in hits]}, ms per cast "
          f"{[round(x, 2) for x in ray_ms]} | card vs CPU over {ray_sub} "
          f"scenes: hits equal, max relative t err {ray_err:.2e} (bound "
          f"1e-5) | ray_poke over body 0, share of scenes whose body 0 gets "
          f"a force: bounds {pokes[False]}, exact {pokes[True]} | "
          f"{time.perf_counter() - t0p:.1f} s | {card}", flush=True)
    if min(hits) < 0.99 or ray_err > 1e-5:
        fail("ray_cast: wrong hits on the card")
    if min(pokes.values()) < 1.0:
        fail("ray_poke: a poked body got no force")

    # 2. The ridge, triangle-exact.
    t0p = time.perf_counter()
    fn, (rarch, rst) = terrain_entry(device=dev, batch=RIDGE_BATCH,
                                     scene="ridge")
    fn(rst)
    sync()
    colored.launches = fused_k.launches = 0
    low, prev = 1e9, None
    t0 = time.perf_counter()
    for _ in range(RIDGE_FRAMES):
        rst, _, ev = fn(rst, prev)
        prev = ev.active
        low = min(low, rst.pos[..., 1].min().item())
    secs = time.perf_counter() - t0
    ridge_launches = (colored.launches, fused_k.launches)
    if ridge_launches != (2 * RIDGE_FRAMES, 0):
        fail(f"ridge: {ridge_launches} colored / fused launches in "
             f"{RIDGE_FRAMES} frames")
    if not _finite(rst):
        fail("ridge: non-finite state")
    rwall = 1e3 * secs / RIDGE_FRAMES
    rkpf, rdev_ms = _profiled(lambda n: [fn(rst) for _ in range(n)])
    ridge_chk = colored_check(rarch, rst, "ridge")
    print(f"ridge (terrain_entry(scene='ridge'), triangle-exact terrain, "
          f"{RIDGE_BATCH} scenes, {RIDGE_FRAMES} frames of 2 substeps): "
          f"{rwall:.2f} ms per frame (each frame reads "
          f"the lowest height), colored launches {ridge_launches[0]}, fused "
          f"{ridge_launches[1]} | the box's lowest height over the run "
          f"{low:.4f} (bound {RIDGE_FLOOR}; vertex-only ~1.45), final mean "
          f"{rst.pos[..., 1].mean().item():.4f} | profiled frame: "
          f"{rkpf:.0f} kernels, device busy {rdev_ms:.3f} ms of the frame's "
          f"{rwall:.3f} ms "
          f"({100 * rdev_ms / rwall:.1f}%) | kernel #1 vs plain at the end: "
          f"max err {ridge_chk['errs']}, {ridge_chk['ms']:.4f} ms, plain "
          f"{ridge_chk['plain_ms']:.1f} ms, bound "
          f"{ridge_chk['bound'][0]:.5f} ({ridge_chk['bound'][1]}) | "
          f"{time.perf_counter() - t0p:.1f} s | {card}", flush=True)
    if not low > RIDGE_FLOOR:
        fail(f"ridge: the box sank to {low:.3f}")
    out.append(kernel_entry(
        "colored_solver_ridge",
        "d3d12renderer_tpu_torch/csrc/colored_solver.cu",
        "d3d12renderer_tpu/physics/solver_pallas.py:619", ridge_launches[0],
        ridge_chk))

    # 3. Cloth, BASELINE config 3.
    cloth_chk = None
    cloth_launches = 0
    for grid, batch in CLOTH_RUNS:
        t0p = time.perf_counter()
        fn, (carch, bst, params, cst) = cloth_entry(device=dev, grid=grid,
                                                    batch=batch)
        settings = PhysicsSettings()
        reason = substep_cuda.support_reason(carch, settings)
        top0 = cst.positions[:, 0].clone()
        ref = (cst.replace(**{k: getattr(cst, k)[:2].cpu() for k in (
            "positions", "prev_positions", "velocities", "forces")}),
            bst.replace(**{k: getattr(bst, k)[:2].cpu()
                           for k in BODY_FIELDS}))
        ball = 0
        colored.launches = fused_k.launches = 0
        clearance = 1e9
        t0 = time.perf_counter()
        for f in range(CLOTH_FRAMES):
            cst, bst = fn(cst, bst)
            if f % 20 == 0:
                clearance = min(clearance, (
                    cst.positions - bst.pos[:, ball, None, None]).norm(
                        dim=-1).min().item())
        sync()
        secs = time.perf_counter() - t0
        launches = (fused_k.launches, colored.launches)
        pinned = (cst.positions[:, 0] - top0).abs().max().item()
        ball_x = bst.pos[:, ball, 0].min().item()
        finite = bool(torch.isfinite(cst.positions).all()) and _finite(bst)
        cwall = 1e3 * secs / CLOTH_FRAMES
        ckpf, cdev_ms = _profiled(lambda n: [fn(cst, bst) for _ in range(n)])
        if grid == CLOTH_RUNS[0][0]:
            # Kernel #2 on the rigid step against its plain version, and
            # the card against the CPU over the first frames.
            plain_set = PhysicsSettings(fused_substep="off",
                                        solver_backend="plain")
            # The main path's bodies hang clear of the plane, so its rigid
            # step is integration only.  The same bodies sunk 2 cm into the
            # plane and falling at 1 m/s make the kernel's narrowphase,
            # prep and solve work on active plane rows; both states are
            # held against plain.
            touch = bst.replace(pos=bst.pos.clone(), vel=bst.vel.clone())
            touch.vel[..., 1] -= 1.0
            touch.pos[:, carch.col_body, 1] = (carch.plane_offset[0]
                                               + carch.col_size[:, 0] - 0.02)
            errs = dict.fromkeys(("pos", "rot", "vel", "omega"), 0.0)
            with torch.inference_mode():
                touching = int(collide.generate_contacts(
                    carch, touch).active.sum())
                for s0 in (bst, touch):
                    kst, _ = step.physics_step(carch, s0, settings,
                                               1.0 / settings.frame_rate)
                    pst, _ = step.physics_step(carch, s0, plain_set,
                                               1.0 / settings.frame_rate)
                    for k in errs:
                        errs[k] = max(errs[k], max_err(getattr(kst, k),
                                                       getattr(pst, k)))
                sync()
                consts = substep_cuda.pack_consts(
                    carch, settings, 1.0 / settings.frame_rate, {}, 0, dev)
                f_ms = cuda_ms(lambda: fused_k(bst, None, consts), 20)
                pl_ms = cuda_ms(lambda: step.physics_step(
                    carch, bst, plain_set, 1.0 / settings.frame_rate), 1)
                cfn, _ = cloth_entry(device="cpu", grid=grid, batch=2)
                rc, rb = ref
                gc = rc.replace(**{k: getattr(rc, k).to(dev) for k in (
                    "positions", "prev_positions", "velocities", "forces")})
                gb = rb.replace(**{k: getattr(rb, k).to(dev)
                                   for k in BODY_FIELDS})
                for _ in range(CLOTH_REF_FRAMES):
                    rc, rb = cfn(rc, rb)
                    gc, gb = fn(gc, gb)
                cref = max(max_err(gc.positions.cpu(), rc.positions),
                           max_err(gb.pos.cpu(), rb.pos))
            # Bound: body state in and out; the solve of the plane rows has
            # no active point (the bodies hang clear of the plane).
            cq = carch.vs_plane_collider.shape[0]
            ctables = solver_cuda.ColoredSolver(carch, cq, ITERATIONS,
                                                "kernel").tables
            cbound = bound(4 * batch * 2 * 19 * bst.pos.shape[1],
                           solve_flop(ctables, batch, 0, ITERATIONS))
            cloth_chk = dict(errs=(errs["vel"], errs["omega"]), ms=f_ms,
                             plain_ms=pl_ms, bound=cbound)
            cloth_launches = launches[0]
            extra = (f" | kernel #2 vs plain on one rigid step, the "
                     f"path's state and the bodies sunk into the plane "
                     f"({touching} active plane rows): max err "
                     f"{json.dumps(errs)} (bounds {POSE_TOL} / {VEL_TOL} / "
                     f"{OMEGA_TOL}), {f_ms:.4f} ms by events, plain rigid "
                     f"step {pl_ms:.1f} ms, bound {cbound[0]:.5f} "
                     f"({cbound[1]}); {cq} plane rows | card vs CPU, 2 "
                     f"scenes x {CLOTH_REF_FRAMES} frames: max err "
                     f"{cref:.2e} (bound {REF_TOL})")
            if touching == 0:
                fail("cloth: no plane row is active at the kernel check")
            if not (errs["pos"] <= POSE_TOL and errs["rot"] <= POSE_TOL
                    and errs["vel"] <= VEL_TOL
                    and errs["omega"] <= OMEGA_TOL):
                fail("cloth: the fused kernel disagrees with its plain "
                     "version")
            if not cref <= REF_TOL:
                fail("cloth: the card disagrees with the CPU path")
        else:
            extra = ""
        print(f"cloth (cloth_entry, BASELINE config 3: {grid} x {grid} "
              f"particles x {batch} scenes, {CLOTH_FRAMES} frames of 1/120 "
              f"s, a sphere and a capsule): rigid route "
              f"{'fused kernel' if reason is None else 'unfused: ' + reason}"
              f", fused launches {launches[0]}, colored {launches[1]} | "
              f"{cwall:.2f} ms per frame | top row moved "
              f"{pinned:.2e}, min clearance from the sphere {clearance:.4f} "
              f"(bound {CLOTH_CLEARANCE}), ball x {ball_x:.3f} (> 0.5), "
              f"finite {finite} | profiled frame: {ckpf:.0f} kernels, device "
              f"busy {cdev_ms:.3f} ms of the frame's {cwall:.3f} ms "
              f"({100 * cdev_ms / cwall:.1f}%){extra} | "
              f"{time.perf_counter() - t0p:.1f} s | {card}", flush=True)
        if reason is not None or launches != (CLOTH_FRAMES, 0):
            fail(f"cloth: the rigid steps did not take the fused kernel "
                 f"({reason}, {launches})")
        if not (finite and pinned == 0.0 and clearance > CLOTH_CLEARANCE
                and ball_x > 0.5):
            fail("cloth: the checks of tests/test_cloth.py failed")
    out.append(kernel_entry(
        "fused_substep_cloth", "d3d12renderer_tpu_torch/csrc/fused_substep.cu",
        "d3d12renderer_tpu/physics/substep_pallas.py:1026", cloth_launches,
        cloth_chk))

    # 4. The vehicle on terrain.
    t0p = time.perf_counter()
    fn, (varch, info, vst) = vehicle_terrain_entry(device=dev)
    fn(vst, 1)
    sync()
    t0 = time.perf_counter()
    vst, _ = fn(vst, VT_FRAMES)
    sync()
    vsecs = time.perf_counter() - t0
    motor = vst.pos[:, info.bodies["motor"]]
    above = (motor[:, 1] - ground(varch, motor)).min().item()
    vwall = 1e3 * vsecs / VT_FRAMES
    vkpf, vdev_ms = _profiled(lambda n: fn(vst, n))
    print(f"vehicle on terrain (vehicle_terrain_entry: 49 x 49 heightmap, "
          f"{vst.pos.shape[0]} scenes, split_jacobi, throttle 10): "
          f"{vwall:.1f} ms per frame over {VT_FRAMES} "
          f"frames | chassis {above:.4f} m above the terrain under it at the "
          f"lowest, finite {_finite(vst)} | profiled frame: {vkpf:.0f} "
          f"kernels, device busy {vdev_ms:.3f} ms of the frame's "
          f"{vwall:.3f} ms "
          f"({100 * vdev_ms / vwall:.1f}%) | "
          f"{time.perf_counter() - t0p:.1f} s | {card}", flush=True)
    if not (_finite(vst) and above > 0.0):
        fail("vehicle on terrain: the chassis left the terrain or the state "
             "is not finite")
    print(f"terrain and cloth phases: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


def training(card, here):
    """The training path: `train_entry` at BASELINE config 5 (4096 envs,
    rollout 32, 8 minibatches, 4 epochs), one warm iteration and
    TRAIN_ITERS timed ones (each one fused launch per rollout step, no
    colored launch), a profiled iteration, a checkpoint round trip of the
    whole TrainState, and the eval render of env 0's final pose through the
    BVH ray kernel, which is then held against its plain version on the
    eval scene's wavefronts."""
    import math
    import statistics

    import torch
    from torch.autograd import DeviceType

    from d3d12renderer_tpu_torch.entry import train_entry
    from d3d12renderer_tpu_torch.learning.loco_env import LocoEnv
    from d3d12renderer_tpu_torch.learning.monitor import summarize
    from d3d12renderer_tpu_torch.ops import ray_trace
    from d3d12renderer_tpu_torch.physics import solver_cuda, substep_cuda
    from d3d12renderer_tpu_torch.physics.types import BodyState
    from d3d12renderer_tpu_torch.render import bvh as bvh_mod
    from d3d12renderer_tpu_torch.render import camera as cam_mod
    from d3d12renderer_tpu_torch.render import pathtracer
    from d3d12renderer_tpu_torch.render.physics_viz import (
        physics_meshes, render_physics_state)
    from d3d12renderer_tpu_torch.utils import checkpoint

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    fused_k, colored = (substep_cuda.fused_substep_cuda,
                        solver_cuda.colored_solve_cuda)
    bvh_k, brute_k = (ray_trace.ray_closest_hit_bvh,
                      ray_trace.ray_closest_hit_brute)

    # 18. train_entry at config 5: one warm iteration, then the timed ones.
    t0 = time.perf_counter()
    train_iteration, state = train_entry()
    sync()
    setup_s = time.perf_counter() - t0
    start = {k: v.clone() for k, v in state.params.items()}
    state, metrics = train_iteration(state)
    sync()
    iter_s, phases = [], []
    for _ in range(TRAIN_ITERS):
        fused_k.launches = colored.launches = 0
        t0 = time.perf_counter()
        state, metrics = train_iteration(state, profile_phases=True)
        iter_s.append(time.perf_counter() - t0)
        phases.append(metrics.pop("phase_ms"))
        if fused_k.launches != TRAIN_ROLLOUT or colored.launches:
            fail(f"training: {fused_k.launches} fused and {colored.launches} "
                 f"colored launches in one iteration (want {TRAIN_ROLLOUT} "
                 "and 0)")
    losses = {k: v.item() for k, v in metrics.items()}
    if not all(math.isfinite(v) for v in losses.values()) or not all(
            bool(torch.isfinite(v).all()) for v in state.params.values()):
        fail(f"training: non-finite losses or parameters {losses}")
    moved = sum(not torch.equal(v, start[k]) for k, v in state.params.items())
    if moved != len(start):
        fail(f"training moved {moved} of {len(start)} parameter tensors")
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = train_iteration(state)
        sync()
        prof_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    fused_ms = sum(e.time_range.elapsed_us() for e in kernels
                   if "fused_substep" in e.name) / 1e3

    # The whole TrainState through a checkpoint: every leaf back bit for bit.
    path = os.path.join(here, "build", "chip_smoke", "train_state.bin")
    checkpoint.save_pytree(path, state)
    back = checkpoint.load_pytree(path)
    pairs = list(zip(checkpoint.tree_leaves(back),
                     checkpoint.tree_leaves(state)))
    for a, b in pairs:
        same = (torch.equal(a.get_state(), b.get_state())
                if isinstance(a, torch.Generator) else
                (a.device == b.device and a.dtype == b.dtype
                 and torch.equal(a, b)) if isinstance(a, torch.Tensor)
                else a == b)
        if not same:
            fail("training: the checkpoint round trip changed a leaf")

    # 19. The eval render of env 0's final pose (train_locomotion.py's
    # --eval-render): 256x256, 8 spp, through the BVH kernel.  The linear
    # image is read where `render` returns it, to check it is finite.
    arch = LocoEnv(device=dev).arch
    bodies0 = BodyState(*(getattr(state.env_state.bodies, f)[0]
                          for f in BODY_FIELDS))
    tris = sum(m.indices.shape[0] for m, _ in physics_meshes(arch, bodies0))
    linear, render = [], pathtracer.render

    def spy(*args, **kw):
        out = render(*args, **kw)
        linear.append(out[0])
        return out

    pathtracer.render = spy
    bvh_k.launches = brute_k.launches = 0
    try:
        t0 = time.perf_counter()
        img = render_physics_state(arch, bodies0, eye=EVAL_EYE,
                                   target=EVAL_TARGET, size=EVAL_SIZE,
                                   spp=EVAL_SPP)
        render_s = time.perf_counter() - t0
    finally:
        pathtracer.render = render
    eval_launches = (bvh_k.launches, brute_k.launches)
    luma = float(img.mean())
    if img.shape != (EVAL_SIZE, EVAL_SIZE, 3) or len(linear) != 1 \
            or not bool(torch.isfinite(linear[0]).all()):
        fail("the eval render is not a finite 256x256 image")
    if eval_launches[0] == 0 or eval_launches[1] != 0 or not 5 < luma < 250:
        fail(f"the eval render: BVH / brute launches {eval_launches}, mean "
             f"luma {luma:.1f}")

    # The BVH kernel at the eval render's shapes, against the plain version
    # (these launches come after the counts were read): the eval scene's
    # tables, its primary wavefront through pixel centres and one bounce
    # wavefront from its hits, closest and any hit.
    eval_bvh = bvh_mod.build_bvh(physics_meshes(arch, bodies0), device=dev)
    planes, nodes = ray_trace.kernel_tables(eval_bvh)
    cam = cam_mod.look_at(EVAL_EYE, EVAL_TARGET, device=dev, aspect=1.0,
                          v_fov=math.radians(50))
    gen = torch.Generator(device=dev).manual_seed(12)
    o, d = cam_mod.generate_rays(cam, EVAL_SIZE, EVAL_SIZE)
    wavefronts = {"primary": (o.contiguous(), d.contiguous())}
    wavefronts["bounce"] = bounces(eval_bvh, *wavefronts["primary"], gen)
    ray_lines = []
    for wf, (o, d) in wavefronts.items():
        for any_hit in (False, True):
            tm = (torch.rand(o.shape[0], generator=gen, device=dev) * 9.5
                  + 0.5 if any_hit else torch.full((o.shape[0],), 1e30,
                                                   device=dev))
            want = ray_trace.closest_hit_plain(planes, o, d, tm)
            n_bad, outside, dt_rel, _ = check_rays(
                "bvh", bvh_k(planes, nodes, o, d, tm, any_hit), want, planes,
                o, d, tm, any_hit)
            mode = "any" if any_hit else "closest"
            ray_lines.append(f"{wf} {mode} {o.shape[0]} rays: {n_bad} differ "
                             f"({outside} outside margins), max |dt| rel "
                             f"{dt_rel:.2e}")
            if outside or dt_rel > MAX_DT_REL:
                fail(f"bvh disagrees with the plain version on the eval "
                     f"scene ({wf}, {mode})")

    med = statistics.median(iter_s)
    steps = TRAIN_ENVS * TRAIN_ROLLOUT
    phase = {k: statistics.median(p[k] for p in phases) for k in phases[0]}
    print(f"training (train_entry: {TRAIN_ENVS} envs, rollout "
          f"{TRAIN_ROLLOUT}, 8 minibatches, 4 epochs; set-up {setup_s:.2f} "
          f"s): {TRAIN_ITERS} iterations after a warm one, "
          f"{' / '.join(f'{1e3 * t:.1f}' for t in iter_s)} ms, median "
          f"{1e3 * med:.1f} ms, {steps / med:.0f} env-steps/s including "
          f"updates | per iteration {TRAIN_ROLLOUT} fused launches, 0 "
          f"colored | CUDA events (medians): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in phase.items())
          + f" | profiler, one iteration: {len(kernels)} kernels, device "
          f"busy {busy_ms:.1f} of {prof_ms:.1f} ms "
          f"({100 * busy_ms / prof_ms:.1f}%), fused kernel {fused_ms:.2f} ms "
          f"| last metrics "
          + ", ".join(f"{k} {v:.4g}" for k, v in losses.items())
          + f", episodes {summarize(state.stats)} | params finite, all "
          f"{len(start)} tensors moved | checkpoint of the TrainState "
          f"({len(pairs)} leaves) bit-equal | eval render of env 0 "
          f"({tris} tris, {EVAL_SIZE}x{EVAL_SIZE}, {EVAL_SPP} spp): "
          f"{render_s:.2f} s, BVH launches {eval_launches[0]}, brute "
          f"{eval_launches[1]}, finite, mean luma {luma:.1f} | BVH kernel vs "
          f"plain on the eval scene ({planes.shape[0]} rows): "
          f"{'; '.join(ray_lines)} | {card}",
          flush=True)


def distributed_training(card, cuda_ms):
    """The distributed phase: `distributed_entry` (NCCL at world size 1,
    4096 envs, BASELINE config 5) for one iteration, which must launch
    kernel #2 once per rollout step; the sharded checkpoint round trip and
    one more iteration from the restored state (loaded onto this rank's
    card by default), equal bit for bit to the iteration from the state
    never saved; `pathtrace_sharded` of the atrium at 1080p in scanline
    bands, equal bit for bit to `pathtracer.render` on the same draws.
    Returns the BVH kernel's and the shading kernels' launches in the
    sharded frame."""
    import math

    import torch
    import torch.distributed as dist

    from d3d12renderer_tpu_torch.entry import distributed_entry, pathtrace_entry
    from d3d12renderer_tpu_torch.ops import pt_shade, ray_trace
    from d3d12renderer_tpu_torch.parallel.data_parallel import train_state_spec
    from d3d12renderer_tpu_torch.parallel.eval_render import pathtrace_sharded
    from d3d12renderer_tpu_torch.physics import substep_cuda
    from d3d12renderer_tpu_torch.render import pathtracer as pt
    from d3d12renderer_tpu_torch.utils import checkpoint

    sync = torch.cuda.synchronize
    fused_k = substep_cuda.fused_substep_cuda
    bvh_k = ray_trace.ray_closest_hit_bvh
    t_phase = time.perf_counter()

    t0 = time.perf_counter()
    init, train, _ = distributed_entry()
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        fail(f"distributed_entry joined {dist.get_backend()} at world size "
             f"{dist.get_world_size()}, want nccl at 1")
    state = init(DIST_SEED)
    sync()
    setup_s = time.perf_counter() - t0
    iter_s = []
    for i in range(2):                   # a warm iteration, then a timed one
        fused_k.launches = 0
        t0 = time.perf_counter()
        state, metrics = train(state)
        sync()
        iter_s.append(time.perf_counter() - t0)
        if fused_k.launches != TRAIN_ROLLOUT:
            fail(f"distributed iteration {i}: {fused_k.launches} fused "
                 f"launches, want {TRAIN_ROLLOUT}")
    losses = {k: v.item() for k, v in metrics.items()}
    if not all(math.isfinite(v) for v in losses.values()):
        fail(f"distributed iteration: non-finite metrics {losses}")

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke", "dist_state.bin")
    t0 = time.perf_counter()
    checkpoint.save_pytree_sharded(path, state, train_state_spec())
    restored = checkpoint.load_pytree_sharded(path, train_state_spec())
    ckpt_s = time.perf_counter() - t0
    here = torch.device("cuda", torch.cuda.current_device())
    if any(x.device != here for x in checkpoint.tree_leaves(restored)
           if isinstance(x, (torch.Tensor, torch.Generator))):
        fail(f"load_pytree_sharded put a part of the state off {here}")
    a, ma = train(state)
    b, mb = train(restored)
    sync()
    leaves = list(zip(checkpoint.tree_leaves(a), checkpoint.tree_leaves(b)))
    for x, y in leaves:
        same = (torch.equal(x.get_state(), y.get_state())
                if isinstance(x, torch.Generator) else
                torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y)
        if not same:
            fail("the iteration from the restored state differs from the "
                 "iteration from the state never saved")
    if not all(torch.equal(ma[k], mb[k]) for k in ma):
        fail("the restored state's iteration has other metrics")

    # pathtrace_sharded of the atrium against pathtracer.render, the same
    # draws: render traces in 32x32 tile order, the bands in scanline
    # order, so the band's per-ray draws are render's put back in scanline
    # order (pixel i takes render's draw inv[i]); the camera's draw, of the
    # image's shape, is the same in both.
    _, (scene, camera, _) = pathtrace_entry(width=PT_W, height=PT_H)
    settings = pt.PathTracerSettings(recursion_depth=SHARDED_DEPTH)
    inv = pt._tile_order(PT_W, PT_H, camera.position.device)[1]

    class Scanline(pt.Sampler):
        def _scanline(self, x):
            return x[inv] if x.dim() and x.shape[0] == inv.shape[0] else x

        def uniform(self, shape):
            return self._scanline(super().uniform(shape))

        def normal(self, shape):
            return self._scanline(super().normal(shape))

    def generator():
        return torch.Generator(device="cuda").manual_seed(DIST_SEED)

    def sharded():
        g = generator()
        return pathtrace_sharded(scene, camera, PT_W, PT_H, dist.group.WORLD,
                                 settings=settings,
                                 camera_sampler=pt.Sampler(g),
                                 sampler=Scanline(g))

    shade_k = pt_shade.shade_hit, pt_shade.shade_next
    with torch.inference_mode():
        sharded()
        bvh_k.launches = 0
        for k in shade_k:
            k.launches = 0
        t0 = time.perf_counter()
        frame = sharded()
        sync()
        sharded_ms = 1e3 * (time.perf_counter() - t0)
        launches = bvh_k.launches
        shade = [k.launches for k in shade_k]
        t0 = time.perf_counter()
        want, _ = pt.render(scene, camera, PT_W, PT_H, settings, spp=1,
                            sampler=pt.Sampler(generator()))
        sync()
        render_ms = 1e3 * (time.perf_counter() - t0)
    if frame.shape != (PT_H, PT_W, 3) or not bool(torch.isfinite(frame).all()):
        fail("pathtrace_sharded's frame is not a finite 1080p image")
    if not torch.equal(frame, want):
        fail(f"pathtrace_sharded differs from render (max "
             f"{(frame - want).abs().max().item():.3e})")
    if launches == 0:
        fail("pathtrace_sharded launched no BVH kernel")
    if shade[0] != shade[1] or shade[0] == 0:
        fail(f"pathtrace_sharded: pt_shade_hit / pt_shade_next launches "
             f"{shade}, want one each a bounce")
    dist.destroy_process_group()
    steps = TRAIN_ENVS * TRAIN_ROLLOUT
    print(f"distributed (distributed_entry: NCCL at world size 1, "
          f"{TRAIN_ENVS} envs per rank, rollout {TRAIN_ROLLOUT}, 8 "
          f"minibatches, 4 epochs; set-up {setup_s:.2f} s): iterations "
          f"{' / '.join(f'{1e3 * t:.1f}' for t in iter_s)} ms (warm, timed), "
          f"{steps / iter_s[-1]:.0f} env-steps/s, {TRAIN_ROLLOUT} fused "
          f"launches each, metrics finite | sharded checkpoint "
          f"({len(leaves)} leaves) save + load {ckpt_s:.2f} s, the next "
          f"iteration from it bit-equal to the one from the state never "
          f"saved | pathtrace_sharded of the atrium {PT_W}x{PT_H}, depth "
          f"{SHARDED_DEPTH}, 1 spp: {sharded_ms:.1f} ms, {launches} BVH "
          f"launches, {shade[0]} + {shade[1]} shading launches, bit-equal to "
          f"render ({render_ms:.1f} ms) | phase "
          f"{time.perf_counter() - t_phase:.1f} s | {card}", flush=True)
    return {"bvh": launches, "shade": sum(shade)}


def raster_options(card, cuda_ms):
    """The raster-options phase: `raster_showcase_entry` (every option of
    examples/showcase.py's frame) and `raster_lights_entry` (128 point
    lights through the Forward+ tile lists) at 1080p, each a warm frame,
    the best of 3 x 5 frames, stage times, a profiled frame; each option's
    effect; kernel #4 on the glass slab against its plain version; each
    entry on the card against the CPU over a 256x144 version of the scene;
    the three modes of `render_mode`.  Returns the ray kernels' launches on
    the two entries' timed frames and #4's error on the glass."""
    import math

    import torch
    from torch.autograd import DeviceType

    from d3d12renderer_tpu_torch import entry as entry_mod
    from d3d12renderer_tpu_torch.core import maths as m
    from d3d12renderer_tpu_torch.ops import image, raster, ray_trace
    from d3d12renderer_tpu_torch.render import lights as lights_mod
    from d3d12renderer_tpu_torch.render import mesh, pipeline, post
    from d3d12renderer_tpu_torch.render import pathtracer as pt
    from d3d12renderer_tpu_torch.render.decals import apply_decals

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    bvh_k, brute_k = ray_trace.ray_closest_hit_bvh, ray_trace.ray_closest_hit_brute
    wrappers = {"bvh": bvh_k, "brute": brute_k, "raster": raster.rasterize_tiles,
                "blur": image.gaussian_blur, "tonemap": image.tonemap}
    t_phase = time.perf_counter()

    def run(name, make):
        t0 = time.perf_counter()
        fn, state = make(device=dev, width=OPT_W, height=OPT_H)
        sync()
        setup_s = time.perf_counter() - t0
        ldr, state, aux = fn(state)                      # warm frame
        sync()
        for k in wrappers.values():
            k.launches = 0
        best = math.inf
        for _ in range(RASTER_RUNS):
            t0 = time.perf_counter()
            for _ in range(RASTER_FRAMES):
                ldr, state, aux = fn(state)
            sync()
            best = min(best, (time.perf_counter() - t0) / RASTER_FRAMES)
        frames = RASTER_RUNS * RASTER_FRAMES
        counts = {n: k.launches for n, k in wrappers.items()}
        if ldr.shape != (OPT_H, OPT_W, 3) or not bool(torch.isfinite(ldr).all()):
            fail(f"{name}: the frame is not a finite 1080p image")
        mean = ldr.mean().item()
        if not 0.0 < mean < 1.0:
            fail(f"{name}: the frame's mean {mean} is not inside (0, 1)")
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn(state)
            sync()
            prof_ms = 1e3 * (time.perf_counter() - t0)
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
        _, _, staged = fn(state, profile_stages=True)
        stages = staged["stage_ms"]
        top = max(stages, key=stages.get)
        print(f"{name} ({OPT_W}x{OPT_H}, set-up {setup_s:.2f} s): best of "
              f"{RASTER_RUNS} runs of {RASTER_FRAMES} frames "
              f"{1e3 * best:.2f} ms per frame ({1 / best:.1f} fps), ldr mean "
              f"{mean:.4f} | launches per frame: "
              + ", ".join(f"{n} {c / frames:g}" for n, c in counts.items())
              + f" | profiler, one frame: {len(kern)} kernels, device busy "
              f"{busy:.1f} of {prof_ms:.1f} ms ({100 * busy / prof_ms:.1f}%) "
              f"| stage ms (CUDA events): "
              + " ".join(f"{k} {v:.2f}" for k, v in stages.items())
              + f"; most: {top} | {card}", flush=True)
        return fn, state, counts, frames

    # The showcase frame.
    fn, state, counts, frames = run("raster_showcase_entry",
                                    entry_mod.raster_showcase_entry)
    if counts["brute"] != frames or counts["bvh"] != 2 * frames:
        fail(f"showcase: BVH / brute launches {counts['bvh']} / "
             f"{counts['brute']} in {frames} frames, want 2 (RT reflections"
             f" closest and any hit) and 1 (the glass) per frame")
    if counts["raster"] != frames or counts["tonemap"] != frames:
        fail(f"showcase: launches {counts}")
    jitter = torch.tensor(OPT_JITTER, device=dev)
    opts = fn.options

    def frame(**overrides):
        return fn(state, jitter=jitter, **overrides)

    base_ldr, _, base = frame()
    gb = base["gbuffer"]
    hit = gb.hit

    def changed(ldr):
        return int(((ldr - base_ldr).abs().amax(-1) > SLICE_PIXEL_TOL).sum())

    checks = {}
    # The spot's cone: pixels the cone reaches are brighter with the spot.
    spot = opts["spot_lights"]
    rel = gb.world_pos - spot.position[0]
    dist_ = torch.linalg.norm(rel, dim=-1)
    in_cone = hit & (torch.sum(rel * spot.direction[0], -1)
                     > spot.outer_cos[0] * dist_) & (dist_ < spot.distance[0])
    _, _, no_spot = frame(spot_lights=None, spot_shadow_maps=None)
    gain = (base["hdr"] - no_spot["hdr"]).sum(-1)[in_cone]
    checks["spot"] = (int(in_cone.sum()), gain.mean().item())
    if checks["spot"][0] < OPT_MIN_PIXELS or not checks["spot"][1] > 0:
        fail(f"the spot cone ({checks['spot'][0]} pixels) is not brighter "
             f"with the spot (mean gain {checks['spot'][1]})")
    # SSS darkens lit pixels.
    s = opts["settings"]
    _, _, no_sss = frame(settings=dataclasses.replace(s, enable_sss=False))
    darker = int(((base["shadow"] < no_sss["shadow"] - 1e-3) & hit).sum())
    checks["sss"] = darker
    if darker < OPT_MIN_PIXELS:
        fail(f"SSS darkened {darker} pixels")
    # RT reflections fill where SSR's confidence is 0.
    _, _, no_rt = frame(settings=dataclasses.replace(
        s, enable_rt_reflections=False))
    conf0 = base["ssr_confidence"] == 0
    filled = conf0 & (base["rt_reflections"].abs().amax(-1) > 0)
    moved = filled & ((base["hdr"] - no_rt["hdr"]).abs().amax(-1) > 0)
    checks["rt"] = (int(conf0.sum()), int(filled.sum()), int(moved.sum()))
    if checks["rt"][2] < OPT_MIN_PIXELS:
        fail(f"RT reflections filled {checks['rt']} (confidence-0, RT "
             "nonzero, changed) pixels")
    # The decal's footprint, the glass and the water.
    footprint = int((apply_decals(gb, opts["decals"]).albedo
                     != gb.albedo).any(-1).sum())
    for name, kw in (("decal", {"decals": None}),
                     ("glass", {"transparent_objects": None}),
                     ("water", {"water_height": None})):
        ldr, _, _ = frame(**kw)
        checks[name] = changed(ldr)
        if checks[name] < OPT_MIN_PIXELS:
            fail(f"the {name} changed {checks[name]} pixels of the frame")
    checks["decal_footprint"] = footprint

    # Kernel #4 at the glass slab's shapes against its plain version: the
    # camera rays of the frame against the slab's 12-row table.
    glass = opts["transparent_objects"][0].bvh
    planes, _ = ray_trace.kernel_tables(glass)
    rd = m.noz(gb.world_pos - fn.camera.position).reshape(-1, 3).contiguous()
    ro = fn.camera.position.expand(rd.shape).contiguous()
    tm = torch.full((ro.shape[0],), 1e30, device=dev)
    got = brute_k(planes, ro, rd, tm)
    want = ray_trace.closest_hit_plain(planes, ro, rd, tm)
    n_bad, outside, dt_rel, glass_err = check_rays("brute", got, want, planes,
                                                   ro, rd, tm, False)
    glass_hits = int((want[1] >= 0).sum())
    glass_ms = cuda_ms(lambda: brute_k(planes, ro, rd, tm), 20)
    glass_plain_ms = cuda_ms(lambda: ray_trace.closest_hit_plain(
        planes, ro, rd, tm), 2)
    if outside or dt_rel > MAX_DT_REL or glass_hits < OPT_MIN_PIXELS:
        fail(f"brute on the glass slab: {n_bad} differ ({outside} outside "
             f"margins), |dt| rel {dt_rel:.2e}, {glass_hits} hits")
    print(f"showcase options (one frame each against the same frame without "
          f"the option, jitter {OPT_JITTER}): spot cone {checks['spot'][0]} "
          f"pixels, mean hdr gain {checks['spot'][1]:.4f} | SSS darkened "
          f"{checks['sss']} lit pixels | RT: {checks['rt'][0]} pixels at SSR "
          f"confidence 0, {checks['rt'][1]} filled by RT, {checks['rt'][2]} "
          f"changed | decal footprint {footprint} pixels, {checks['decal']} "
          f"changed | glass {checks['glass']} | water {checks['water']} "
          f"pixels changed | brute kernel on the glass slab "
          f"({planes.shape[0]} rows x {ro.shape[0]} rays, {glass_hits} "
          f"hits): {n_bad} differ from plain ({outside} outside margins), "
          f"max |dt| rel {dt_rel:.2e}, {glass_ms:.3f} ms (plain "
          f"{glass_plain_ms:.1f} ms) | {card}", flush=True)

    # The Forward+ frame: its tiles, some over MAX_LIGHTS_PER_TILE.
    fn_l, state_l, counts_l, frames_l = run("raster_lights_entry",
                                            entry_mod.raster_lights_entry)
    if counts_l["bvh"] or counts_l["brute"] or counts_l["raster"] != frames_l:
        fail(f"lights: launches {counts_l}")
    _, _, aux_l = fn_l(state_l)
    lights = fn_l.options["point_lights"]
    with torch.inference_mode():
        _, tile_count = lights_mod.cull_lights_tiled(
            aux_l["gbuffer"].view_pos, lights, fn_l.camera, OPT_W, OPT_H)
    over = int((tile_count > lights_mod.MAX_LIGHTS_PER_TILE).sum())
    if over == 0:
        fail("no tile of the 128-light frame passes more than "
             f"{lights_mod.MAX_LIGHTS_PER_TILE} lights")

    # The host cost of the eager loops: kernels of one call (two profiler
    # sessions of 3 and 2 calls, differenced: a session misses its first
    # kernels) and CUDA-event time per call.
    def kernels_per_call(f):
        counts = []
        for calls in (3, 2):
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    f()
                sync()
            counts.append(sum(1 for e in prof.events()
                              if e.device_type == DeviceType.CUDA))
        return counts[0] - counts[1]

    gbl = aux_l["gbuffer"]
    sun_view = m.quat_inv_rotate(fn_l.camera.rotation,
                                 fn_l.scene.sky.sun_direction)
    vp_low = post.downsample2(gbl.view_pos)
    loops = {
        "cull_lights_tiled": lambda: lights_mod.cull_lights_tiled(
            gbl.view_pos, lights, fn_l.camera, OPT_W, OPT_H),
        "shade_point_lights": lambda: lights_mod.shade_point_lights(
            gbl, lights, tile_lists, fn_l.camera),
        "screen_space_shadows (half res)": lambda: post.screen_space_shadows(
            vp_low, sun_view, None, pipeline.RendererSettings().sss),
    }
    with torch.inference_mode():
        tile_lists, _ = loops["cull_lights_tiled"]()
        loop_rows = [f"{k} {kernels_per_call(f)} kernels, {cuda_ms(f, 5):.2f}"
                     f" ms" for k, f in loops.items()]
    print(f"raster_lights_entry tiles: {tile_count.numel()} tiles of "
          f"{lights_mod.TILE_SIZE}^2, {int((tile_count > 0).sum())} with a "
          f"light, {over} with more than {lights_mod.MAX_LIGHTS_PER_TILE} "
          f"(most {int(tile_count.max())}), mean "
          f"{tile_count.float().mean().item():.2f} | eager loops at "
          f"{OPT_W}x{OPT_H}, per call: {'; '.join(loop_rows)} | {card}",
          flush=True)

    # The card against the CPU over a 256x144 version of the scene: the
    # entries' frames (`_showcase_frames`, `_lights_frames`) of the raster
    # slice's meshes in the atrium's set-up, every map at OPT_SLICE_MAPS^2.
    small = slice_meshes(mesh)
    builders = {"raster_showcase_entry": entry_mod._showcase_frames,
                "raster_lights_entry": entry_mod._lights_frames}
    rows = []
    for name, frames in builders.items():
        out = []
        for device in (dev, torch.device("cpu")):
            scene_s, camera_s = entry_mod._atrium(device, OPT_SLICE_W,
                                                  OPT_SLICE_H, small)
            f = frames(scene_s, camera_s, OPT_SLICE_W, OPT_SLICE_H, device,
                       0, OPT_SLICE_MAPS)
            st = pipeline.initial_frame_state(OPT_SLICE_W, OPT_SLICE_H,
                                              device)
            imgs = []
            for jit in ((0.25, 0.6), (0.7, 0.3)):
                img, st, _ = f(st, jitter=torch.tensor(jit, device=device))
                imgs.append(img.cpu())
            out.append(imgs)
        for i, (g, c) in enumerate(zip(*out)):
            err = (g - c).abs().amax(-1)
            share = (err <= SLICE_PIXEL_TOL).float().mean().item()
            rows.append(f"{name} frame {i + 1}: {100 * share:.2f}% within "
                        f"{SLICE_PIXEL_TOL}, mean {err.mean().item():.2e}")
            if share < SLICE_SHARE or not err.mean().item() < RASTER_MEAN_TOL:
                fail(f"{name}: the card's slice frame {i + 1} disagrees "
                     f"with the CPU ({100 * share:.2f}% within "
                     f"{SLICE_PIXEL_TOL}, mean {err.mean().item():.2e})")
    print(f"card vs CPU over the new entries ({OPT_SLICE_W}x{OPT_SLICE_H}, "
          f"the raster slice's scene, maps {OPT_SLICE_MAPS}^2, two frames "
          f"with TAA history): {'; '.join(rows)} (bounds "
          f"{100 * SLICE_SHARE:.0f}%, {RASTER_MEAN_TOL})", flush=True)

    # The three modes of render_mode at 1080p.
    scene, camera = fn.scene, fn.camera
    mode_rows = []
    with torch.inference_mode():
        for mode in pipeline.RENDER_MODES:
            t0 = time.perf_counter()
            img = pipeline.render_mode(
                scene, camera, OPT_W, OPT_H, mode, spp=MODE_SPP,
                sampler=pt.Sampler(torch.Generator(device=dev).manual_seed(1)))
            sync()
            secs = time.perf_counter() - t0
            if img.shape != (OPT_H, OPT_W, 3) or not bool(
                    torch.isfinite(img).all()):
                fail(f"render_mode {mode}: not a finite 1080p image")
            mode_rows.append(f"{mode} {secs:.2f} s, mean "
                             f"{img.mean().item():.4f}")
    print(f"render_mode at {OPT_W}x{OPT_H} (path traced at {MODE_SPP} spp): "
          f"{'; '.join(mode_rows)} | phase {time.perf_counter() - t_phase:.1f}"
          f" s", flush=True)
    return {"bvh": counts["bvh"] + counts_l["bvh"],
            "brute": counts["brute"] + counts_l["brute"],
            "glass_err": glass_err}


def showcase_world(card, cuda_ms):
    """examples/showcase.py's whole world through `showcase_world_entry` at
    1080p: the set-up (the drop's 180 frames through kernel #1, the atlas
    and probes through #3), a warm frame and the best of 3 x 5 frames
    (#3 RT reflections, #4 glass, #5 raster, #6 tonemap, #7 blur), stage
    times, a profiled frame and its kernels; the world's checks; kernels
    #1, #3, #4 and #5 against their plain versions at this path's shapes;
    the card against the CPU at 256x144.  Returns the launches and errors
    this path adds to the kernels line."""
    import math

    import torch
    from torch.autograd import DeviceType

    from d3d12renderer_tpu_torch import convert
    from d3d12renderer_tpu_torch.core import maths as m
    from d3d12renderer_tpu_torch.entry import showcase_world_entry
    from d3d12renderer_tpu_torch.models import world as world_mod
    from d3d12renderer_tpu_torch.ops import image, raster, ray_trace
    from d3d12renderer_tpu_torch.physics import solver_cuda, step
    from d3d12renderer_tpu_torch.physics.types import PhysicsSettings
    from d3d12renderer_tpu_torch.render import pipeline
    from d3d12renderer_tpu_torch.terrain.heightmap import (
        sample_height_bilinear)

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    wrappers = {"colored": solver_cuda.colored_solve_cuda,
                "bvh": ray_trace.ray_closest_hit_bvh,
                "brute": ray_trace.ray_closest_hit_brute,
                "raster": raster.rasterize_tiles,
                "tonemap": image.tonemap, "blur": image.gaussian_blur}
    t_phase = time.perf_counter()

    # The main path: set-up (the drop with collision events and its audio
    # mix, as examples/showcase.py --audio), a warm frame, the timed frames.
    audio_dir = tempfile.TemporaryDirectory()
    wav = os.path.join(audio_dir.name, "showcase.wav")
    for k in wrappers.values():
        k.launches = 0
    t0 = time.perf_counter()
    fn, state = showcase_world_entry(device=dev, width=OPT_W, height=OPT_H,
                                     audio=wav)
    sync()
    setup_s = time.perf_counter() - t0
    setup = {n: k.launches for n, k in wrappers.items()}
    ldr, state, aux = fn(state)
    sync()
    best = math.inf
    for _ in range(RASTER_RUNS):
        t0 = time.perf_counter()
        for _ in range(RASTER_FRAMES):
            ldr, state, aux = fn(state)
        sync()
        best = min(best, (time.perf_counter() - t0) / RASTER_FRAMES)
    counts = {n: k.launches for n, k in wrappers.items()}
    frames = 1 + RASTER_RUNS * RASTER_FRAMES
    per_frame = {n: (counts[n] - setup[n]) / frames for n in counts}
    world = fn.world
    drop_frames = world_mod.WorldConfig().physics_frames
    if counts["colored"] != 2 * drop_frames:
        fail(f"showcase world: {counts['colored']} colored launches in the "
             f"drop's {drop_frames} frames, want 2 a frame")
    for n in ("raster", "tonemap", "bvh", "brute", "blur"):
        if not per_frame[n] >= 1:
            fail(f"showcase world: kernel {n} launched {per_frame[n]} times "
                 "a frame")
    if ldr.shape != (OPT_H, OPT_W, 3) or not bool(torch.isfinite(ldr).all()):
        fail("showcase world: the frame is not a finite 1080p image")
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(state)
        sync()
        prof_ms = 1e3 * (time.perf_counter() - t0)
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    _, _, staged = fn(state, profile_stages=True)
    stages = staged["stage_ms"]
    c = world.counts
    print(f"showcase world (showcase_world_entry, {OPT_W}x{OPT_H}): set-up "
          f"{setup_s:.2f} s (launches {json.dumps(setup)}) | "
          f"{c['triangles']} triangles in {c['meshes']} meshes, "
          f"{c['chunks']} terrain chunks at LODs {c['chunk_lods']}, "
          f"{c['trees']} placed trees ({c['tree_meshes']} tree meshes), "
          f"{c['visible_blades']} visible blades in {c['visible_chunks']} "
          f"chunks (LOD0 {c['lod0_blades']} / LOD1 {c['lod1_blades']}), "
          f"{int(world.fire.alive.sum())} fire particles alive | best of "
          f"{RASTER_RUNS} runs of {RASTER_FRAMES} frames {1e3 * best:.2f} ms "
          f"per frame ({1 / best:.1f} fps) | launches per frame: "
          + ", ".join(f"{n} {v:g}" for n, v in per_frame.items())
          + f" | profiler, one frame: {len(kern)} kernels, device busy "
          f"{busy:.1f} of {prof_ms:.1f} ms ({100 * busy / prof_ms:.1f}%), "
          f"most device time: "
          + "; ".join(f"{n[:48]} {v:.2f} ms" for n, v in top)
          + " | stage ms (CUDA events): "
          + " ".join(f"{k} {v:.2f}" for k, v in stages.items())
          + f"; most: {max(stages, key=stages.get)} | {card}", flush=True)

    # The world's checks.
    cell = world_mod.WORLD_SIZE / (world.heights.shape[0] - 1)
    pos = world.bodies.pos[0].cpu()
    under, _ = sample_height_bilinear(world.heights, world_mod.WORLD_ORIGIN,
                                      cell, pos[:, 0], pos[:, 2])
    clearance = (pos[:, 1] - under).min().item()
    cube = world.scene.sky.cubemap
    peak = cube.max().item()
    jitter = torch.tensor(OPT_JITTER, device=dev)
    base, _, base_aux = fn(state, jitter=jitter)
    procedural = dataclasses.replace(
        world.scene, sky=world_mod.load_sky(dev, 1, None)[0])
    proc, _, _ = fn(state, jitter=jitter, scene=procedural)

    def changed(a, b):
        return int(((a - b).abs().amax(-1) > SLICE_PIXEL_TOL).sum())

    sky_px, splat_px = changed(base, proc), changed(base, base_aux["frame_ldr"])
    print(f"showcase world checks: bodies at least {clearance:.4f} m above "
          f"the terrain under them (bound {TERRAIN_CLEARANCE}) | cubemap "
          f"{tuple(cube.shape)} peak {peak:.4f} (equirect peak "
          f"{c['envmap_peak']:.4f}, which it must equal) | the HDR sky "
          f"changes {sky_px} pixels against the procedural sky, the particle "
          f"splat {splat_px} (bound {OPT_MIN_PIXELS} each) | main path and "
          f"checks {time.perf_counter() - t_phase:.1f} s", flush=True)
    if not clearance > TERRAIN_CLEARANCE:
        fail(f"showcase world: a body rests {clearance:.4f} m above the "
             "terrain")
    if not (peak == c["envmap_peak"] and peak > 1.0):
        fail(f"showcase world: the cubemap's peak {peak} is not the HDR "
             f"equirect's {c['envmap_peak']}")
    if sky_px < OPT_MIN_PIXELS or splat_px < OPT_MIN_PIXELS:
        fail(f"showcase world: the sky changed {sky_px} and the splat "
             f"{splat_px} pixels")
    world_audio(fn.audio, audio_dir)

    # Kernels #1, #3, #4 and #5 at this path's shapes against their plain
    # versions (these launches are not counted).
    t_check = time.perf_counter()
    gb = base_aux["gbuffer"]
    cam = fn.camera
    errs = {}
    with torch.inference_mode():
        settings = PhysicsSettings()
        sp = step.substep_prep(world.arch, world.bodies,
                               1.0 / settings.frame_rate, settings)
        solver = solver_cuda.ColoredSolver(
            world.arch, sp.contacts.body_a.shape[0], ITERATIONS, "kernel")
        sargs = (sp.joint_preps, sp.contact_prep, sp.vel1, sp.omega1)
        kv, kw = solver(*sargs)
        pv, pw = solver.plain(*sargs)
        colored_errs = ((kv - pv).abs().max().item(),
                        (kw - pw).abs().max().item())
        errs["colored"] = max(colored_errs)
        rd = m.noz(gb.world_pos - cam.position).reshape(-1, 3)
        step_ = max(1, rd.shape[0] // RAY_SUBSET)
        rd = rd[::step_][:RAY_SUBSET].contiguous()
        ro = cam.position.expand(rd.shape).contiguous()
        tm = torch.full((ro.shape[0],), 1e30, device=dev)
        for name, b in (("bvh", world.scene.bvh),
                        ("brute", fn.options["transparent_objects"][0].bvh)):
            planes, nodes = ray_trace.kernel_tables(b)
            got = (ray_trace.ray_closest_hit_bvh(planes, nodes, ro, rd, tm)
                   if name == "bvh" else
                   ray_trace.ray_closest_hit_brute(planes, ro, rd, tm))
            want = ray_trace.closest_hit_plain(planes, ro, rd, tm)
            n_bad, outside, dt_rel, err = check_rays(
                name, got, want, planes, ro, rd, tm, False)
            if outside or dt_rel > MAX_DT_REL:
                fail(f"showcase world: kernel {name} disagrees with plain on "
                     f"the frame's rays ({n_bad} differ, {outside} outside "
                     f"the margins, |dt| rel {dt_rel:.2e})")
            errs[name] = err
        wp = OPT_W + (-OPT_W) % raster.TILE_X
        hp = OPT_H + (-OPT_H) % raster.TILE_Y
        b = world.scene.bvh
        mat, attr = raster.perspective_rows(cam, OPT_W, OPT_H)
        planes, rect, q_tri = raster.project_planes(
            b.tri_v0, b.tri_e1, b.tri_e2, b.tri_valid, mat, attr, wp, hp)
        pair_tri, seg = raster.bin_pairs(rect, q_tri, wp, hp)
        rargs = (planes, pair_tri, seg, jitter, wp, hp)
        rgot, rwant = raster.rasterize_tiles(*rargs), \
            raster.rasterize_plain(*rargs)
        if not all(torch.equal(a, w) for a, w in zip(rgot, rwant)):
            fail("showcase world: the raster kernel differs from its plain "
                 "version on the world's 1080p tiles")
        errs["raster"] = 0.0
    if not (colored_errs[0] <= VEL_TOL and colored_errs[1] <= OMEGA_TOL):
        fail(f"showcase world: the colored kernel disagrees with its plain "
             f"version: {colored_errs}")
    print(f"showcase world kernels vs plain: colored (batch 1, the drop's "
          f"terrain rows) |dvel|, |domega| {colored_errs}; BVH ({b.tri_valid.shape[0]} "
          f"rows) and brute (the glass) on {ro.shape[0]} camera rays, max "
          f"|dt| {errs['bvh']:.3e} / {errs['brute']:.3e}; raster "
          f"({int(seg[-1])} pairs at {wp}x{hp}) bit-equal | "
          f"{time.perf_counter() - t_check:.1f} s", flush=True)

    # The card against the CPU over a 256x144 world (maps and physics cut),
    # the CPU's fire pool copied from the card run.
    t_slice = time.perf_counter()
    cfg = dataclasses.replace(world_mod.WorldConfig(), **WORLD_SLICE)
    out = []
    pool = None
    for device in (dev, torch.device("cpu")):
        f, st = showcase_world_entry(device=device, width=OPT_SLICE_W,
                                     height=OPT_SLICE_H, config=cfg)
        if pool is None:
            pool = f.world.fire
        else:
            f.world.fire = convert.particle_pool_from_numpy(
                {k: getattr(pool, k).cpu().numpy() for k in (
                    "position", "velocity", "age", "lifetime", "alive",
                    "emit_carry")} | {"data": {k: v.cpu().numpy() for k, v
                                               in pool.data.items()}},
                torch.Generator(), "cpu")
        imgs = []
        for jit in ((0.25, 0.6), (0.7, 0.3)):
            img, st, _ = f(st, jitter=torch.tensor(jit, device=device))
            imgs.append(img.cpu())
        out.append(imgs)
    rows = []
    for i, (g, cpu_img) in enumerate(zip(*out)):
        err = (g - cpu_img).abs().amax(-1)
        share = (err <= SLICE_PIXEL_TOL).float().mean().item()
        rows.append(f"frame {i + 1}: {100 * share:.2f}% within "
                    f"{SLICE_PIXEL_TOL}, mean {err.mean().item():.2e}")
        if share < SLICE_SHARE or not err.mean().item() < RASTER_MEAN_TOL:
            fail(f"showcase world: the card's slice frame {i + 1} disagrees "
                 f"with the CPU ({rows[-1]})")
    print(f"card vs CPU over the world ({OPT_SLICE_W}x{OPT_SLICE_H}, "
          f"{json.dumps(WORLD_SLICE)}, the fire pool copied from the card, "
          f"two frames with TAA history): {'; '.join(rows)} (bounds "
          f"{100 * SLICE_SHARE:.0f}%, {RASTER_MEAN_TOL}) | "
          f"{time.perf_counter() - t_slice:.1f} s; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"launches": counts, "errs": errs}


def _read_wav(path):
    """(frames, channels) float32 of a PCM16 WAV, and its rate."""
    import wave

    import numpy as np

    with wave.open(path, "rb") as w:
        rate, ch = w.getframerate(), w.getnchannels()
        raw = w.readframes(w.getnframes())
    return (np.frombuffer(raw, np.int16).astype(np.float32).reshape(-1, ch)
            / 32767.0, rate)


def world_audio(sound, audio_dir):
    """The world's audio: impacts from the drop's collision-begin events
    (kernel #1's frames), the mixdown's WAV of frames / 60 + 0.5 s, and the
    same timeline (a new engine: a synth voice renders once) streamed block
    by block into a WAV equal to it within AUDIO_TOL."""
    from d3d12renderer_tpu_torch.audio.stream import stream_to_wav
    from d3d12renderer_tpu_torch.models.world import impact_engine

    t0 = time.perf_counter()
    impacts, seconds = sound["impacts"], sound["seconds"]
    mixed, rate = _read_wav(sound["path"])
    streamed_path = os.path.join(audio_dir.name, "streamed.wav")
    stats = stream_to_wav(impact_engine(impacts), seconds, streamed_path)
    streamed, _ = _read_wav(streamed_path)
    err = float(abs(streamed - mixed).max()) if streamed.shape == \
        mixed.shape else math.inf
    audio_dir.cleanup()
    speeds = [s for _, _, s in impacts]
    print(f"showcase world audio: {len(impacts)} impacts (begin events "
          f"faster than {IMPACT_SPEED} m/s, "
          f"{min(speeds, default=0):.3f}-{max(speeds, default=0):.3f} m/s, "
          f"first at {impacts[0][0] if impacts else -1:.3f} s) -> WAV "
          f"{mixed.shape[0] / rate:.3f} s at {rate} Hz, peak "
          f"{float(abs(mixed).max()):.4f}; streamed in {stats['blocks']} "
          f"blocks, max |stream - mixdown| {err:.3e} (bound {AUDIO_TOL}) | "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if not impacts:
        fail("showcase world audio: the drop made no impact")
    if mixed.shape[0] != int(round(seconds * rate)) or not \
            float(abs(mixed).max()) > 0:
        fail(f"showcase world audio: the WAV holds {mixed.shape[0]} frames "
             f"for {seconds} s, peak {float(abs(mixed).max())}")
    if not err <= AUDIO_TOL:
        fail(f"showcase world audio: the streamed WAV differs from the "
             f"mixdown by {err}")


def _lowest_points(scene, physics):
    """Each dynamic body's lowest collider point (y) from /physics'
    positions and the bodies' rotations."""
    import numpy as np

    low = {}
    rot = physics["rot"]
    for ent, (rb,) in scene.view("rigid_body"):
        if rb.kinematic:
            continue
        row = physics["bodies"][str(ent.id)]
        p = np.asarray(row["position"], np.float64)
        x, y, z, w = rot[str(ent.id)]
        r = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                       2 * (x * z + w * y)],
                      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                       2 * (y * z - w * x)],
                      [2 * (x * z - w * y), 2 * (y * z + w * x),
                       1 - 2 * (x * x + y * y)]])
        ys = []
        for col in ent.get("collider"):
            c = p + r @ np.asarray(col.center, np.float64)
            if col.shape == "sphere":
                ys.append(c[1] - col.size[0])
            elif col.shape == "box":
                h = np.asarray(col.size, np.float64)
                corners = np.array([[sx, sy, sz] for sx in (-1, 1)
                                    for sy in (-1, 1) for sz in (-1, 1)]) * h
                ys.append(float((c + corners @ r.T)[:, 1].min()))
            else:
                fail(f"editor: no lowest-point rule for {col.shape}")
        low[ent.name] = min(ys)
    return low


def editor_cpu_panels(size):
    """The editor's first view's panels on the CPU: the demo scene through
    the same YAML text, its compiled poses, the first orbit.  Returns the
    document read, the orbit's centre and radius, the panels and the
    seconds taken."""
    import yaml

    from d3d12renderer_tpu_torch.scene import viewer
    from d3d12renderer_tpu_torch.scene.scene import Scene

    t0 = time.perf_counter()
    doc = yaml.safe_load(yaml.safe_dump(
        viewer.build_demo_scene().to_document(), sort_keys=False))
    sc = Scene.from_document(doc)
    rs = sc.build_render_scene(*sc.compile_physics(device="cpu")[1:],
                               device="cpu")
    center, radius = viewer.scene_center_radius(rs)
    cam = viewer.orbit_camera(center, radius, 0.0, viewer.STATIC_PHI,
                              device="cpu")
    panels = viewer.aux_buffers(rs, cam, size)
    return dict(doc=doc, center=center, radius=radius, panels=panels,
                s=time.perf_counter() - t0)


def editor(card, cuda_ms, max_err):
    """The editor path through `editor_entry` at the JAX tool's defaults:
    the demo scene through YAML, the static page (4 views path-traced
    through kernel #3, the panels), the live viewer driven through every
    endpoint, play for EDITOR_PLAY_FRAMES frames (kernel #1, or #2 where
    the archetype is in its family), stop.  Checks: the YAML round trip,
    the page, the panels against a CPU run, every endpoint, undo / redo,
    the bodies after play, the editor scene after stop; kernel #3 on the
    first view's camera rays and kernel #1 on the play state against their
    plain versions; one play frame through the kernel against the plain
    solve at EDITOR_BARS.  Returns the launches and errors this path adds
    to the kernels line."""
    import numpy as np
    import torch

    from d3d12renderer_tpu_torch.entry import _kernel_wrappers, editor_entry
    from d3d12renderer_tpu_torch.ops import ray_trace
    from d3d12renderer_tpu_torch.physics import solver_cuda, step
    from d3d12renderer_tpu_torch.physics.types import PhysicsSettings
    from d3d12renderer_tpu_torch.render.camera import generate_rays
    from d3d12renderer_tpu_torch.scene import viewer
    from d3d12renderer_tpu_torch.scene.scene import Scene

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    t_phase = time.perf_counter()

    wrappers = _kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    out = editor_entry(device=dev, size=EDITOR_SIZE,
                       play_frames=EDITOR_PLAY_FRAMES)
    sync()
    entry_s = time.perf_counter() - t_phase
    launches = {k: w.launches for k, w in wrappers.items()}
    cpu_ref = editor_cpu_panels(EDITOR_SIZE)
    s, page = out["session"], out["static"]
    size = EDITOR_SIZE
    problems = []

    def check(ok, what):
        if not ok:
            problems.append(what)

    # YAML, page, endpoints, undo / redo, play, stop.
    written, read = (json.loads(json.dumps(d)) for d in out["yaml"])
    check(written == read, "the YAML round trip changed the scene")
    n_img = page["html"].count("data:image/png;base64,")
    check(len(page["views"]) == 4 and len(page["aux"]) == 4 and n_img == 8,
          f"the page holds {len(page['views'])} views, {len(page['aux'])} "
          f"panels, {n_img} images")
    check(all(v.shape == (size, size, 3) for v in page["views"]),
          "a view is not size x size RGB")
    png, png2 = s["orbit_pngs"]
    check(s["page"] and png[:4] == b"\x89PNG" and png2[:4] == b"\x89PNG"
          and png != png2, "two orbits did not give two PNGs")
    check(all(v[:4] == b"\x89PNG" for v in s["kinds"].values()),
          "an aux kind is not a PNG")
    check(s["edited_render"][:4] == b"\x89PNG", "the edited scene's render")
    check(s["edit_x"] == [0.0, 3.0, 0.0, 3.0], f"edit / undo / redo moved "
          f"RedSphere to x {s['edit_x']}")
    check(s["undo_redo_names"] == ["edit RedSphere"] * 3
          and s["info_after_redo"]["undo"] == "edit RedSphere",
          f"undo names {s['undo_redo_names']}")
    check(s["play_mode"] == "play" and s["play_pngs_differ"]
          and s["frames"] == (EDITOR_PLAY_FRAMES, EDITOR_PLAY_FRAMES)
          and s["pause_mode"] == "pause", f"play / pause: frames "
          f"{s['frames']}, modes {s['play_mode']} {s['pause_mode']}")
    check(s["edit_during_play"] == 409, f"a transform edit during play "
          f"answered {s['edit_during_play']}")
    check(s["stop_mode"] == "edit" and s["red_after_stop"][1] == 2.2
          and s["doc_before_play"] == s["doc_after_stop"],
          "the editor scene changed through play and stop")
    check(s["material_albedo"] == [0.75, 0.9, 0.75],
          f"material edit / undo: {s['material_albedo']}")
    w0, w1 = s["paddle_spin"]
    check(abs(w0) < 0.5 and abs(w1) > 2.0 and s["motor_targets"] ==
          [0.0, 6.0, 0.0], f"the paddle's motor retarget: spins {w0} "
          f"{w1}, targets {s['motor_targets']}")
    check(json.loads(json.dumps(s["doc_final"])) == read,
          "the editor scene after the session is "
          "not the scene read from YAML")

    # The bodies after play: finite and above the plane.
    arch, st, mo, mapping = s["play_tables"]
    finite = all(bool(torch.isfinite(getattr(st, f)).all())
                 for f in ("pos", "rot", "vel", "omega"))
    rot = st.rot[0].cpu().numpy()
    phys = dict(s["physics"], rot={str(e): rot[b].tolist()
                                   for e, b in mapping.items()})
    low = _lowest_points(Scene.from_document(read), phys)
    check(finite and min(low.values()) >= EDITOR_FLOOR,
          f"bodies after play: finite {finite}, lowest points {low}")

    # The panels against the CPU run of the same functions.
    check(cpu_ref["doc"] == read and np.array_equal(cpu_ref["center"],
                                                    page["center"])
          and cpu_ref["radius"] == page["radius"],
          "the CPU run's scene or orbit is not the page's")
    want, cpu_s = cpu_ref["panels"], cpu_ref["s"]
    got = page["aux_float"]
    hit, whit = np.isfinite(got["depth"]), np.isfinite(want["depth"])
    same = hit & whit & (got["object id"] == want["object id"])
    edge = float((~same & (hit | whit)).mean())
    field_bad = {}
    for f in ("normals", "depth"):
        err = np.abs(got[f][same] - want[f][same])
        scale = np.maximum(1.0, np.abs(want[f][same]))
        field_bad[f] = float((err > EDITOR_FIELD_TOL * scale).reshape(
            err.shape[0], -1).any(-1).mean())
    ao_err = np.abs(got["AO"] - want["AO"])
    ao_share = float((ao_err <= SLICE_PIXEL_TOL).mean())
    check(edge <= EDITOR_EDGE_SHARE and max(field_bad.values()) <=
          EDITOR_EDGE_SHARE and ao_share >= SLICE_SHARE and
          float(ao_err.mean()) < RASTER_MEAN_TOL,
          f"panels against the CPU: edge share {edge}, fields {field_bad}, "
          f"AO {ao_share} within {SLICE_PIXEL_TOL}, mean {ao_err.mean()}")

    # Its renders shade through both kernels, one launch each a bounce.
    check(launches["shade_hit"] == launches["shade_next"] > 0,
          f"pt_shade_hit / pt_shade_next launches {launches['shade_hit']} / "
          f"{launches['shade_next']}")

    # Kernels #3 and #1 against their plain versions at this path's shapes,
    # and one play frame through the kernel against the plain solve (these
    # launches are not counted).
    scene_dev = Scene.from_document(read)
    rscene = scene_dev.build_render_scene(
        *scene_dev.compile_physics(device=dev)[1:], device=dev)
    errs = {}
    with torch.inference_mode():
        t_check = time.perf_counter()
        o, d = generate_rays(page["camera"], size, size)
        pick = slice(None, None, max(1, o.shape[0] // RAY_SUBSET))
        o, d = o[pick].contiguous(), d[pick].contiguous()
        tm = torch.full((o.shape[0],), 1e30, device=dev)
        planes, nodes = ray_trace.kernel_tables(rscene.bvh)
        rows = planes.shape[0]
        kernel = "bvh" if rows > 1024 else "brute"
        got_r = (ray_trace.ray_closest_hit_bvh(planes, nodes, o, d, tm)
                 if kernel == "bvh" else
                 ray_trace.ray_closest_hit_brute(planes, o, d, tm))
        want_r = ray_trace.closest_hit_plain(planes, o, d, tm)
        n_bad, outside, dt_rel, errs[kernel] = check_rays(
            kernel, got_r, want_r, planes, o, d, tm, False)
        check(not outside and dt_rel <= MAX_DT_REL, f"kernel {kernel} on "
              f"the first view's rays: {n_bad} differ, {outside} outside "
              f"the margins, |dt| rel {dt_rel}")
        rays_s = time.perf_counter() - t_check
        settings = PhysicsSettings()
        sp = step.substep_prep(arch, st, 1.0 / settings.frame_rate,
                               settings, mo)
        solver = solver_cuda.ColoredSolver(
            arch, sp.contacts.body_a.shape[0], ITERATIONS, "kernel")
        sargs = (sp.joint_preps, sp.contact_prep, sp.vel1, sp.omega1)
        kv, kw = solver(*sargs)
        pv, pw = solver.plain(*sargs)
        colored_errs = (max_err(kv, pv), max_err(kw, pw))
        errs["colored"] = max(colored_errs)
        check(colored_errs[0] <= VEL_TOL and colored_errs[1] <= OMEGA_TOL,
              f"kernel #1 against plain on the play state: {colored_errs}")
        # One play frame from the state after play (the bodies resting on
        # the plane, the hinge), kernel against the plain solve.
        k_frame = step.physics_step(arch, st, settings, viewer.PLAY_DT,
                                    motor_overrides=mo)[0]
        p_frame = step.physics_step(
            arch, st, PhysicsSettings(solver_backend="plain"),
            viewer.PLAY_DT, motor_overrides=mo)[0]
        frame_errs = {f: max_err(getattr(k_frame, f), getattr(p_frame, f))
                      for f in EDITOR_BARS}
    check(all(frame_errs[f] <= EDITOR_BARS[f] for f in EDITOR_BARS),
          f"one play frame, kernel against plain: {frame_errs}")
    check_s = time.perf_counter() - t_check
    ms = {k: sorted(v) for k, v in out["ms"].items()}
    print(f"editor (editor_entry, size {size}, 4 views, spp 6, "
          f"{EDITOR_PLAY_FRAMES} play frames at spp {viewer.PLAY_SPP}): "
          f"entry {entry_s:.1f} s (static page {out['static_s']:.2f} s, "
          f"session {out['session_s']:.1f} s) | "
          f"launches: colored #1 {launches['colored']}, fused #2 "
          f"{launches['fused']}, BVH #3 {launches['bvh']}, brute #4 "
          f"{launches['brute']}, pt_shade_hit / pt_shade_next "
          f"{launches['shade_hit']} / {launches['shade_next']} | ms per "
          f"request (host clock, median / max "
          f"of n): " + "; ".join(
              f"{k} {v[len(v) // 2]:.1f} / {v[-1]:.1f} of {len(v)}"
              for k, v in ms.items())
          + f" | physics {page['physics']} | bodies' lowest points "
          + ", ".join(f"{k} {v:.4f}" for k, v in low.items())
          + f" | panels vs CPU ({cpu_s:.1f} s on the CPU): edge share "
          f"{edge:.2e}, fields off {field_bad}, AO {100 * ao_share:.2f}% "
          f"within {SLICE_PIXEL_TOL}, mean {ao_err.mean():.2e} | {kernel} "
          f"kernel vs plain over {rows} rows, {o.shape[0]} rays: max |dt| "
          f"{errs[kernel]:.3e}; colored vs plain on the play state "
          f"|dvel|, |domega| {colored_errs}; one play frame after play, "
          f"kernel vs plain {frame_errs} (bars {EDITOR_BARS}); the checks "
          f"{check_s:.1f} s (the rays {rays_s:.1f}) | phase "
          f"{time.perf_counter() - t_phase:.1f} s | {card}", flush=True)
    if problems:
        fail("editor: " + "; ".join(problems))
    return {"launches": launches, "errs": errs,
            "play_kernel": "fused" if launches["fused"] else "colored"}


def flythrough(card, cuda_ms, max_err):
    """examples/flythrough.py's path through `flythrough_entry` at
    1920x1080: FLY_SETTLE_FRAMES frames of physics, FLY_FRAMES filmed
    frames of its game frame `fn` (each a physics step of two substeps
    through the colored-solver kernel, replayed from a CUDA graph after the
    first frame; then, replayed from a second CUDA graph after the first
    filmed frame, the instances posed into their tree, the sun's cascades
    through the BVH ray kernel, the raster primary through the raster
    kernel, the SSR march kernel, the bloom's and sharpen's blurs and the
    tonemap), their launches counted through the replays (one colored
    launch a substep); the last filmed frame's launches of the
    raster, tonemap, blur, SSR and BVH kernels each against its plain
    version on the inputs that frame gave it; the solver kernel against its
    plain version on one substep of the settled pile; one profiled frame.

    The inputs are recorded by wrapping the launch helpers, which run in
    eager frames and in a graph's capture, not in its replays.  A record
    made in the capture holds the graph's own tensors (the record's
    reference keeps the capture from reusing their memory for later
    operations), and every replay writes the frame's values into them: after
    the last filmed frame they hold that frame's inputs and outputs, so the
    last records of each kernel are the last frame's.  Returns the launches
    and errors for the kernels line."""
    import collections

    import torch
    from torch.autograd import DeviceType

    from d3d12renderer_tpu_torch import entry as entry_mod
    from d3d12renderer_tpu_torch.ops import image, raster, ray_trace
    from d3d12renderer_tpu_torch.ops import ssr as ssr_ops
    from d3d12renderer_tpu_torch.physics import (collide, solver_cuda, step,
                                                 substep_cuda)
    from d3d12renderer_tpu_torch.physics.types import PhysicsSettings
    from d3d12renderer_tpu_torch.render import post

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    t_phase = time.perf_counter()
    wrappers = {"colored": solver_cuda.colored_solve_cuda,
                "fused": substep_cuda.fused_substep_cuda,
                "bvh": ray_trace.ray_closest_hit_bvh,
                "brute": ray_trace.ray_closest_hit_brute,
                "raster": raster.rasterize_tiles,
                "groups": raster.rasterize_groups,
                "tonemap": image.tonemap, "blur": image.gaussian_blur,
                "ssr": ssr_ops.ssr_march}
    # Each launch's inputs and outputs, recorded by wrapping the modules'
    # launch helpers (the wrappers above still launch and count once).
    recorded = collections.defaultdict(list)
    hooks = {"raster": (raster, "launch"), "blur": (image, "blur_launch"),
             "tonemap": (image, "tonemap_launch"),
             "bvh": (ray_trace, "launch"), "ssr": (post, "ssr_march")}
    originals = {k: getattr(mod, name) for k, (mod, name) in hooks.items()}

    def recorder(kind):
        def launch(*args, **kw):
            out = originals[kind](*args, **kw)
            recorded[kind].append((args, kw, out))
            return out
        return launch

    for k, w in wrappers.items():
        w.launches = 0
    for k, (mod, name) in hooks.items():
        setattr(mod, name, recorder(k))
    try:
        t0 = time.perf_counter()
        out = entry_mod.flythrough_entry(device=dev, width=OPT_W,
                                         height=OPT_H, frames=FLY_FRAMES,
                                         settle_frames=FLY_SETTLE_FRAMES)
        sync()
        run_s = time.perf_counter() - t0
        counts = {k: w.launches for k, w in wrappers.items()}
        frame_records = {k: [r for r in v] for k, v in recorded.items()}
        recorded.clear()
    finally:
        for k, (mod, name) in hooks.items():
            setattr(mod, name, originals[k])
    frames = out["frames"]
    substeps = entry_mod.FLYTHROUGH_SUBSTEPS * (FLY_SETTLE_FRAMES
                                                + FLY_FRAMES)
    per_frame = {k: counts[k] / FLY_FRAMES for k in
                 ("raster", "tonemap", "blur", "bvh", "ssr")}
    if counts["colored"] != substeps or counts["fused"] or counts["brute"] \
            or counts["groups"] or not all(
                v >= 1 and v == int(v) for v in per_frame.values()):
        fail(f"flythrough: launches {json.dumps(counts)} over "
             f"{FLY_SETTLE_FRAMES} + {FLY_FRAMES} frames: want one colored "
             f"launch a substep ({substeps}), no fused, brute or group "
             "launch, and a whole number (at least one) of raster, tonemap, "
             "blur, SSR and BVH launches a filmed frame")
    phys_graphs = [bool(g) for g in out["physics"].graphs.values()]
    frame_graphs = out["graphs"]
    if phys_graphs != [True] or out["physics"].failed \
            or frame_graphs.captures != 1 or frame_graphs.failed \
            or frame_graphs.replays != FLY_FRAMES - 1:
        fail(f"flythrough: the physics frame's graph {phys_graphs} "
             f"({out['physics'].failed}), the posed frame's graph: "
             f"{frame_graphs.captures} captures, {frame_graphs.replays} "
             f"replays, failed {list(frame_graphs.failed.values())}")
    last = frames[-1]
    heights = out["state"].pos[0, :, 1]
    if len(frames) != FLY_FRAMES or last.shape != (OPT_H, OPT_W, 3) \
            or not all(bool(torch.isfinite(f).all()) for f in frames) \
            or not float(heights.min()) > 0.2 \
            or not float(out["state"].pos.abs().max()) < 20.0:
        fail(f"flythrough: frames {len(frames)} of {tuple(last.shape)}, "
             f"finite {[bool(torch.isfinite(f).all()) for f in frames]}, "
             f"heights {heights.tolist()}")
    moved = float((frames[0] - frames[-1]).abs().mean())
    if not moved > 1e-3:
        fail(f"flythrough: the first and last frames differ by {moved}")

    # The last filmed frame's launches against the plain versions.
    t_check = time.perf_counter()
    errs = {}
    last_of = {k: v[-int(per_frame[k]):] for k, v in frame_records.items()}
    with torch.inference_mode():
        for args, kw, got in last_of["raster"]:
            planes, pair_tri, seg, jitter, w, h = args[1:7]
            want = raster.rasterize_plain(planes, pair_tri, seg, jitter, w, h)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                fail("flythrough: the raster kernel differs from its plain "
                     "version on the filmed frame")
        errs["raster"] = 0.0
        k = image.tonemap_constants(post.TonemapSettings())
        for args, kw, got in last_of["tonemap"]:
            x, a = args[1], args[2]
            if bytes(a) != bytes(image.tonemap_args(k, False)):
                fail("flythrough: the frame's tonemap is not the default "
                     "settings' without sRGB")
            if not torch.equal(got, image.tonemap_plain(x, k, False)):
                fail("flythrough: the tonemap kernel differs from its plain "
                     "version on the filmed frame")
        errs["tonemap"] = 0.0
        shapes = []
        for args, kw, got in last_of["blur"]:
            img, taps = args[1], args[2]
            shapes.append(f"{tuple(img.shape)} r {taps.shape[0] // 2}")
            if not torch.equal(got, image.blur_plain(img, taps.to(dev))):
                fail(f"flythrough: the blur kernel differs from its plain "
                     f"version on the filmed frame at {shapes[-1]}")
        errs["blur"] = 0.0
        for args, kw, got in last_of["ssr"]:
            want = ssr_ops.ssr_march_plain(*args[:11], args[11], args[12])
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                fail("flythrough: the SSR march kernel differs from its "
                     "plain version on the filmed frame")
        errs["ssr"] = 0.0
        ray_rows = []
        errs["bvh"] = 0.0
        for args, kw, got in last_of["bvh"]:
            planes, nodes, o, d, tm, any_hit = args[1:7]
            want = ray_trace.closest_hit_plain(planes, o, d, tm, any_hit)
            n_bad, outside, dt_rel, dt = check_rays(
                "flythrough cascades", got, want, planes, o, d, tm, any_hit)
            ray_rows.append(f"{o.shape[0]} rays: {n_bad} differ "
                            f"({outside} off the margins), max |dt| rel "
                            f"{dt_rel:.1e}")
            errs["bvh"] = max(errs["bvh"], dt)
            if outside or dt_rel > MAX_DT_REL:
                fail("flythrough: the BVH kernel disagrees with its plain "
                     "version on the frame's cascades")
    check_s = time.perf_counter() - t_check

    # The solver kernel against its plain version on one substep of the
    # settled pile.
    world, settled = out["world"], out["settled"]
    psettings = PhysicsSettings()
    plain_set = PhysicsSettings(solver_backend="plain")
    reason = substep_cuda.support_reason(world.arch, psettings)
    dt = 1.0 / psettings.frame_rate
    with torch.inference_mode():
        contacts = collide.generate_contacts(world.arch, settled)
        active = int(contacts.active.sum())
        before = wrappers["colored"].launches
        kst, _ = step.physics_step(world.arch, settled, psettings, dt, 1)
        pst, _ = step.physics_step(world.arch, settled, plain_set, dt, 1)
        sync()
        launched = wrappers["colored"].launches - before
        sub_err = {f: max_err(getattr(kst, f), getattr(pst, f))
                   for f in ("pos", "rot", "vel", "omega")}
    if active == 0 or launched != 1 or reason is None:
        fail(f"flythrough: the settled pile has {active} active contact rows "
             f"(want > 0); its substep launched {launched} colored solves; "
             f"fused family: {reason}")
    if not (sub_err["pos"] <= POSE_TOL and sub_err["rot"] <= POSE_TOL
            and sub_err["vel"] <= VEL_TOL and sub_err["omega"] <= OMEGA_TOL):
        fail(f"flythrough: the colored kernel disagrees with plain on the "
             f"settled pile: {json.dumps(sub_err)}")
    errs["colored"] = max(sub_err.values())

    # One more frame under the profiler: the device's busy share.
    state, fstate = out["state"], out["frame_state"]
    cam, prev = out["camera"](FLY_FRAMES), out["camera"](FLY_FRAMES - 1)
    jit = torch.tensor([0.5, 0.5], device=dev)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        state, bvh = out["advance"](state)
        out["render"](bvh, cam, prev, fstate, jit)
        sync()
        prof_ms = 1e3 * (time.perf_counter() - t0)
        time.sleep(PROFILE_PAD_S)
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    phase_s = time.perf_counter() - t_phase
    print(f"flythrough (flythrough_entry, {OPT_W}x{OPT_H}, 18 bodies, "
          f"{int(world.instances.valid.sum())} triangles posed a frame): "
          f"settle {FLY_SETTLE_FRAMES} frames {out['settle_s']:.2f} s, "
          f"{FLY_FRAMES} filmed frames, {out['ms_per_frame']:.2f} ms a frame "
          f"past the first ({out['frame_ms'][0]:.1f} ms), entry "
          f"{run_s:.1f} s | launches {json.dumps(counts)} (per filmed frame "
          f"{json.dumps(per_frame)}; graphs: physics {phys_graphs}, frame "
          f"{frame_graphs.captures} capture / {frame_graphs.replays} "
          f"replays) | last filmed frame vs plain: raster, tonemap, SSR "
          f"and {len(last_of['blur'])} blurs ({'; '.join(shapes)}) "
          f"bit-equal; BVH kernel on the cascades: {'; '.join(ray_rows)} "
          f"({check_s:.1f} s) | the pile's fused family: {reason}; one "
          f"substep of the settled pile ({active} active contact rows), "
          f"colored kernel vs plain max err {json.dumps(sub_err)} (bounds "
          f"{POSE_TOL} / {VEL_TOL} / {OMEGA_TOL}) | heights min "
          f"{float(heights.min()):.3f} max {float(heights.max()):.3f} | "
          f"profiler, one frame: {len(kern)} kernels, device busy "
          f"{busy:.1f} of {prof_ms:.1f} ms ({100 * busy / prof_ms:.1f}%), "
          "most device time: "
          + "; ".join(f"{n[:40]} {v:.2f} ms" for n, v in top)
          + f" | {card} | phase {phase_s:.1f} s", flush=True)
    return {"launches": counts, "errs": errs, "ms_per_frame":
            out["ms_per_frame"], "busy": busy / prof_ms}


def characters(card, cuda_ms, max_err):
    """Skinned characters through `character_entry` at 1080p: set-up (the
    static atrium's 3 cascades through kernel #3), CHAR_FRAMES frames
    through the group path with feedback (kernel #5's group mode), each
    against the pair path on its own BVH, the frame's times, profile and
    stages; the overlays; the group kernel against its plain version with
    and without feedback, garbage and stale feedback against none, its
    counters (per row band: visits run and skipped, rows tested and
    culled) against the rows any exact cull per band must test, its
    registers and shared memory, its time beside the pair kernel's on the
    same frame and its bound; card
    against CPU; then the fitted ragdolls' drop through kernel #2 (or #1)
    against plain.  Returns the launches, errors and the group kernel's
    line for the kernels line."""
    import math

    import torch
    from torch.autograd import DeviceType

    from d3d12renderer_tpu_torch import cuda_build
    from d3d12renderer_tpu_torch import entry as entry_mod
    from d3d12renderer_tpu_torch.entry import (character_entry,
                                               character_ragdoll_entry)
    from d3d12renderer_tpu_torch.ops import image, raster, ray_trace
    from d3d12renderer_tpu_torch.physics import collide, solver_cuda, step
    from d3d12renderer_tpu_torch.physics import substep_cuda
    from d3d12renderer_tpu_torch.physics.types import PhysicsSettings
    from d3d12renderer_tpu_torch.render import camera as cam_mod
    from d3d12renderer_tpu_torch.render import mesh as mesh_mod
    from d3d12renderer_tpu_torch.render.skinned_instances import (
        build_frame_bvh)

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    t_phase = time.perf_counter()
    wrappers = {"groups": raster.rasterize_groups,
                "pairs": raster.rasterize_tiles,
                "bvh": ray_trace.ray_closest_hit_bvh,
                "tonemap": image.tonemap, "blur": image.gaussian_blur,
                "fused": substep_cuda.fused_substep_cuda,
                "colored": solver_cuda.colored_solve_cuda}
    gen = torch.Generator().manual_seed(11)
    jitters = torch.rand((CHAR_FRAMES, 2), generator=gen).to(dev)

    # The main path: set-up, a warm frame, CHAR_FRAMES frames.
    for k in wrappers.values():
        k.launches = 0
    t0 = time.perf_counter()
    fn, state = character_entry(device=dev, width=OPT_W, height=OPT_H)
    sync()
    setup_s = time.perf_counter() - t0
    setup = {n: k.launches for n, k in wrappers.items()}
    ldr, state, aux = fn(state)
    frames = []
    t0 = time.perf_counter()
    for i in range(CHAR_FRAMES):
        ldr, state, aux = fn(state, jitter=jitters[i])
        frames.append((aux["bvh"], aux["visits"], ldr, aux["frame_ldr"]))
    sync()
    frames_ms = 1e3 * (time.perf_counter() - t0) / CHAR_FRAMES
    best = math.inf
    for _ in range(RASTER_RUNS):
        t0 = time.perf_counter()
        for _ in range(CHAR_FRAMES):
            ldr, state, aux = fn(state)
        sync()
        best = min(best, (time.perf_counter() - t0) / CHAR_FRAMES)
    counts = {n: k.launches for n, k in wrappers.items()}
    n_frames = 1 + CHAR_FRAMES * (1 + RASTER_RUNS)
    per_frame = {n: (counts[n] - setup[n]) / n_frames for n in counts}
    if setup["bvh"] < 1 or counts["pairs"] or not per_frame["groups"] >= 1 \
            or not per_frame["tonemap"] >= 1 or not per_frame["blur"] >= 1:
        fail(f"characters: launches {json.dumps(counts)} (set-up "
             f"{json.dumps(setup)}): want the sun's cascades through kernel "
             "#3 (one launch), every frame through the group kernel, the tonemap and the "
             "blur, and no pair-kernel launch")
    if ldr.shape != (OPT_H, OPT_W, 3) or not bool(torch.isfinite(ldr).all()):
        fail("characters: the frame is not a finite 1080p image")
    # What the occlusion feedback is worth: runs of CHAR_FRAMES frames
    # without it (the carried tile_qmin dropped before each frame: one
    # launch over every visit) in turns with runs with it, best of
    # RASTER_RUNS each; after the main path's counts are read.
    fb_ms = {"with": math.inf, "without": math.inf}
    for _ in range(RASTER_RUNS):
        for mode in ("without", "with"):
            t0 = time.perf_counter()
            for _ in range(CHAR_FRAMES):
                if mode == "without":
                    state = entry_mod.CharacterState(state.frame, None,
                                                     state.time)
                ldr, state, aux = fn(state)
            sync()
            fb_ms[mode] = min(fb_ms[mode], 1e3 * (time.perf_counter() - t0)
                              / CHAR_FRAMES)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(state)
        sync()
        prof_ms = 1e3 * (time.perf_counter() - t0)
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    _, _, staged = fn(state, profile_stages=True)
    stages = staged["stage_ms"]
    rows = frames[0][0].tri_v0.shape[0]
    skinned_rows = rows - fn.rigid.v0.shape[0]
    print(f"characters (character_entry, {OPT_W}x{OPT_H}, "
          f"{len(fn.skinned)} characters): set-up {setup_s:.2f} s (launches "
          f"{json.dumps(setup)}) | {rows} rows a frame ({skinned_rows} "
          f"skinned, {rows // raster.GROUP} groups) | {CHAR_FRAMES} frames "
          f"{frames_ms:.2f} ms each, best of {RASTER_RUNS} runs of "
          f"{CHAR_FRAMES} {1e3 * best:.2f} ms per frame | in turns, best of "
          f"{RASTER_RUNS} runs of {CHAR_FRAMES}: {fb_ms['with']:.2f} ms a "
          f"frame with the feedback, {fb_ms['without']:.2f} without | "
          f"visits per frame "
          f"(phase 1, phase 2, dirty tiles): "
          + " ".join(f"{v['phase1']}/{v['phase2']}/{v['dirty']}"
                     for _, v, _, _ in frames)
          + " | launches per frame: "
          + ", ".join(f"{n} {v:g}" for n, v in per_frame.items())
          + f" | profiler, one frame: {len(kern)} kernels, device busy "
          f"{busy:.1f} of {prof_ms:.1f} ms ({100 * busy / prof_ms:.1f}%), "
          "most device time: "
          + "; ".join(f"{n[:40]} {v:.2f} ms" for n, v in top)
          + " | stage ms (CUDA events): "
          + " ".join(f"{k} {v:.2f}" for k, v in stages.items())
          + f" | {card}", flush=True)

    # Each of the CHAR_FRAMES frames against the pair path on its BVH: t
    # equal everywhere, and every pixel whose winner differs a tie (both
    # triangles give the pixel the same q; each path keeps its own order).
    # The overlays change pixels.
    t_check = time.perf_counter()
    cam = fn.camera
    wp = OPT_W + (-OPT_W) % raster.TILE_X
    hp = OPT_H + (-OPT_H) % raster.TILE_Y
    ties = 0
    with torch.inference_mode():
        for i, (bvh, _, out, base_ldr) in enumerate(frames):
            jit = jitters[i]
            g = raster.closest_hit_raster(bvh, cam, OPT_W, OPT_H, jitter=jit,
                                          binning="group")
            p = raster.closest_hit_raster(bvh, cam, OPT_W, OPT_H, jitter=jit)
            if not torch.equal(g["t"], p["t"]):
                fail(f"characters: frame {i}: t differs between the group "
                     f"and pair paths at "
                     f"{int((g['t'] != p['t']).sum())} pixels")
            same = g["tri"] == p["tri"]
            if not torch.equal(g["uv"][same], p["uv"][same]):
                fail(f"characters: frame {i}: uv differs where tri agrees")
            diff = torch.nonzero(~same)[:, 0]
            if not diff.numel():
                continue
            mat, attr = raster.perspective_rows(cam, OPT_W, OPT_H)
            planes, _, _ = raster.project_planes(
                bvh.tri_v0, bvh.tri_e1, bvh.tri_e2, bvh.tri_valid, mat, attr,
                wp, hp)
            x = (diff % OPT_W).float() + jit[0]
            y = (diff // OPT_W).float() + jit[1]

            def q_of(tri):
                r = planes[tri.long()]
                return (r[:, 9] * x + r[:, 10] * y) + r[:, 11]

            tie = q_of(g["tri"][diff]) == q_of(p["tri"][diff])
            if not bool(tie.all()):
                fail(f"characters: frame {i}: {int((~tie).sum())} pixels' "
                     "winners differ between the group and pair paths "
                     "without a tie")
            ties += int(tie.sum())
        overlay = [int((out != b).any(-1).sum()) for _, _, out, b in frames]
        moved = (build_frame_bvh(None, None, None, fn.skinned, fn.phases.to(
            dev)).tri_v0 - build_frame_bvh(None, None, None, fn.skinned,
                                           fn.phases.to(dev) + 1.0).tri_v0)
        moved = moved.abs().amax().item()
    if min(overlay) < CHAR_MIN_PIXELS or not moved > 0.05:
        fail(f"characters: overlays changed {overlay} pixels, the skinned "
             f"rows moved {moved} between t = 0 and 1")

    # The group kernel against its plain version on the first frame's
    # tables, without and with feedback (its own, 1e6, another camera's);
    # these launches are not the main path's.
    bvh = frames[0][0]
    jit = jitters[0]
    mat, attr = raster.perspective_rows(cam, OPT_W, OPT_H)
    tables = raster.build_frame_tables(bvh.tri_v0, bvh.tri_e1, bvh.tri_e2,
                                       bvh.tri_valid, mat, attr, wp, hp)
    other = cam_mod.look_at(CHAR_STALE_EYE, CHAR_STALE_TARGET, device=dev,
                            v_fov=math.radians(60), aspect=OPT_W / OPT_H)
    kernel_fn = raster.rasterize_groups

    def run(plain, **kw):
        raster.rasterize_groups = (
            (lambda pl, plan, j, w, h, base=None, stats=None:
             raster.rasterize_groups_plain(pl, plan, j, w, h, base))
            if plain else kernel_fn)
        try:
            return raster.closest_hit_raster(bvh, cam, OPT_W, OPT_H,
                                             jitter=jit, **kw)
        finally:
            raster.rasterize_groups = kernel_fn

    with torch.inference_mode():
        none_k = run(False, binning="group")
        stale_fb = raster.closest_hit_raster(bvh, other, OPT_W, OPT_H,
                                             jitter=jit,
                                             binning="group")["tile_qmin"]
        feedback = {"none": None, "own": none_k["tile_qmin"],
                    "garbage": torch.full_like(none_k["tile_qmin"], 1e6),
                    "stale": stale_fb}
        plain_t0 = time.perf_counter()
        results = {}
        for name, fb in feedback.items():
            k = none_k if fb is None else run(False, tile_qmin=fb)
            pl = run(True, binning="group", tile_qmin=fb)
            results[name] = (k, pl)
            for key in ("t", "tri", "uv", "tile_qmin"):
                if not torch.equal(k[key], pl[key]):
                    fail(f"characters: the group kernel differs from its "
                         f"plain version ({name} feedback, {key})")
            if not all(torch.equal(k[key], none_k[key])
                       for key in ("t", "tri", "uv")):
                fail(f"characters: {name} feedback changes the frame")
        plain_s = time.perf_counter() - plain_t0
        # The query (tables, plan, launches, host reads) without and with
        # this frame's own feedback.
        q_ms = {"without": cuda_ms(lambda: raster.closest_hit_raster(
                    bvh, cam, OPT_W, OPT_H, jitter=jit, binning="group"),
                    RASTER_RUNS),
                "own": cuda_ms(lambda: raster.closest_hit_raster(
                    bvh, cam, OPT_W, OPT_H, jitter=jit,
                    tile_qmin=feedback["own"]), RASTER_RUNS)}
        plan = raster.visit_plan(tables, wp, hp, jit)
        stats = torch.zeros(4, dtype=torch.int64, device=dev)
        kernel_fn(tables, plan, jit, wp, hp, stats=stats)
        run_v, skip_v, rows_tested, rows_culled = stats.tolist()
        planes, rect, q_tri = raster.project_planes(
            bvh.tri_v0, bvh.tri_e1, bvh.tri_e2, bvh.tri_valid, mat, attr,
            wp, hp)
        pair_tri, seg = raster.bin_pairs(rect, q_tri, wp, hp)
        g_ms = cuda_ms(lambda: kernel_fn(tables, plan, jit, wp, hp),
                       RASTER_REPS)
        p_ms = cuda_ms(lambda: raster.rasterize_tiles(planes, pair_tri, seg,
                                                      jit, wp, hp),
                       RASTER_REPS)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        sync()
        start.record()
        want = raster.rasterize_groups_plain(tables, plan, jit, wp, hp)
        end.record()
        sync()
        g_plain_ms = start.elapsed_time(end)
        # The visits any exact cull at the tile's granularity must run:
        # those whose bound (the largest q the group's triangles of the
        # tile give any sample of it, exact) exceeds the tile's least
        # final q.
        least = raster.tile_min(want[0], wp, hp)
        needed = int((plan.bound > least[plan.visit_tile]).sum())
        # The bound counts the (visit, band, row) tests any exact cull of
        # a row per band must run, the kernel's granularity; its rows
        # tested cover them.
        g_bound = group_bound(raster, tables, plan, want[0], jit, wp, hp)
        rows_needed = g_bound[2] // (raster.PX // raster.GROUP_BANDS)
        per_tile = (plan.seg[1:] - plan.seg[:-1]).long()
        jax_drops = int(torch.clamp(per_tile - raster.VISIT_CAP, min=0).sum())
    if run_v + skip_v != raster.GROUP_BANDS * plan.visits \
            or not rows_needed <= rows_tested:
        fail(f"characters: the group kernel's counters: {run_v} visits run "
             f"+ {skip_v} skipped, want {raster.GROUP_BANDS} x "
             f"{plan.visits}; {rows_tested} rows tested, any exact cull per "
             f"band must test {rows_needed}")
    g_ptxas = ptxas_summary((cuda_build.build_library().parent
                             / "build.log").read_text(), "raster_groups")
    fb_visits = {n: r[0]["visits"] for n, r in results.items()}
    print(f"characters: group path vs pair path over the {CHAR_FRAMES} "
          f"frames: t equal, uv equal where tri is, tri equal but at "
          f"{ties} pixels of exact ties | overlays changed {overlay} pixels (bound "
          f"{CHAR_MIN_PIXELS}) | skinned rows moved {moved:.3f} between "
          f"t = 0 and 1 | group kernel vs plain, frame 1 at {wp}x{hp}: t, "
          f"tri, uv and tile_qmin bit-equal with feedback none / own / "
          f"1e6 / stale, each equal to none; visits (phase 1, phase 2, "
          f"dirty) {json.dumps(fb_visits)} ({plain_s:.1f} s) | "
          f"{plan.visits} visits over {plan.tiles.numel()} tiles (at most "
          f"{int(per_tile.max())} a tile; JAX's cap of {raster.VISIT_CAP} "
          f"would drop {jax_drops}), "
          f"{needed} any exact cull per tile must run | per (visit, band), {raster.GROUP_BANDS} bands "
          f"a tile: {run_v} run, {skip_v} skipped by the early-out; in "
          f"those run, {rows_tested} rows tested, {rows_culled} culled, "
          f"{rows_needed} that any exact cull of a row per band must test | "
          f"{g_ptxas} | "
          f"the query {q_ms['without']:.3f} ms without feedback, "
          f"{q_ms['own']:.3f} with its own (CUDA events) | group kernel {g_ms:.3f} ms, pair kernel "
          f"{p_ms:.3f} ms ({int(seg[-1])} pairs) on the same "
          f"frame (CUDA events), plain {g_plain_ms:.1f} ms, bound "
          f"{g_bound[0]:.4f} ms ({g_bound[1]}: {g_bound[2]} (visit, band, "
          f"row, pixel) tests; counted per tile, "
          f"{g_bound[3]} tests, "
          f"{1e3 * g_bound[3] * RASTER_PAIR_FLOP / FP32_FLOP_PER_S:.4f} ms) "
          f"| {card} | "
          f"{time.perf_counter() - t_check:.1f} s", flush=True)

    # The card against the CPU over 256x144: the raster slice's meshes,
    # CHAR_SLICE_CROWD characters, OPT_SLICE_MAPS^2 cascades, two frames
    # with feedback carried.
    t_slice = time.perf_counter()
    saved = (mesh_mod.atrium_scene, entry_mod.RASTER_SHADOW_RESOLUTION)
    mesh_mod.atrium_scene = lambda detail: slice_meshes(mesh_mod)
    entry_mod.RASTER_SHADOW_RESOLUTION = OPT_SLICE_MAPS
    try:
        imgs = []
        for device in (dev, torch.device("cpu")):
            f, st = character_entry(device=device, width=OPT_SLICE_W,
                                    height=OPT_SLICE_H,
                                    crowd=CHAR_SLICE_CROWD, coarse=True)
            out = []
            for jit_ in ((0.25, 0.6), (0.7, 0.3)):
                img, st, _ = f(st, jitter=torch.tensor(jit_, device=device))
                out.append(img.cpu())
            imgs.append(out)
    finally:
        mesh_mod.atrium_scene, entry_mod.RASTER_SHADOW_RESOLUTION = saved
    rows_ = []
    for i, (g_img, c_img) in enumerate(zip(*imgs)):
        err = (g_img - c_img).abs().amax(-1)
        share = (err <= SLICE_PIXEL_TOL).float().mean().item()
        rows_.append(f"frame {i + 1}: {100 * share:.2f}% within "
                     f"{SLICE_PIXEL_TOL}, mean {err.mean().item():.2e}")
        if share < SLICE_SHARE or not err.mean().item() < SLICE_MEAN_TOL:
            fail(f"characters: the card's slice frame {i + 1} disagrees "
                 f"with the CPU ({rows_[-1]})")
    print(f"card vs CPU over the characters ({OPT_SLICE_W}x{OPT_SLICE_H}, "
          f"the raster slice's meshes, {CHAR_SLICE_CROWD} coarse characters, "
          f"cascades {OPT_SLICE_MAPS}^2, feedback carried): "
          f"{'; '.join(rows_)} (bounds {100 * SLICE_SHARE:.0f}%, "
          f"{SLICE_MEAN_TOL}) | {time.perf_counter() - t_slice:.1f} s",
          flush=True)

    # The fitted ragdolls' drop.
    t_drop = time.perf_counter()
    for k in wrappers.values():
        k.launches = 0
    dfn, (arch, dstate, fitted) = character_ragdoll_entry(
        device=dev, batch=CHAR_DROP_BATCH)
    settings = PhysicsSettings(frame_rate=entry_mod.RAGDOLL_FRAME_RATE)
    reason = substep_cuda.support_reason(arch, settings)
    st = dstate
    with torch.inference_mode():
        st, _ = dfn(st, 1)
        sync()
        t0 = time.perf_counter()
        st, _ = dfn(st, CHAR_DROP_FRAMES - 1)
        sync()
    drop_s = time.perf_counter() - t0
    launches = {"fused": wrappers["fused"].launches,
                "colored": wrappers["colored"].launches}
    pos = st.pos
    finite = all(bool(torch.isfinite(getattr(st, f)).all())
                 for f in ("pos", "rot", "vel", "omega"))
    low, far = pos[..., 1].min().item(), pos.abs().max().item()
    kernel = "fused" if reason is None else "colored"
    if launches[kernel] != CHAR_DROP_FRAMES or not finite \
            or not low > CHAR_FLOOR or not far < CHAR_BOUND:
        fail(f"characters: the ragdoll drop: launches {launches} in "
             f"{CHAR_DROP_FRAMES} frames (kernel {kernel}), finite {finite}, "
             f"lowest {low:.3f}, farthest {far:.3f}")
    # Kernel against plain on one step: the first frame's state (in the
    # air, spinning) and the fitted pose lowered until its lowest capsule is
    # 2 cm into the plane, falling at 1 m/s (active plane rows, every joint
    # far from its limits).  The landed heap at frame CHAR_DROP_FRAMES is
    # reported without a bound: its resting contacts and its joints held
    # at their limits sit on a knife edge where the kernel's contracted
    # multiply-adds flip a row on or off (ROADMAP Queue 3); the kernel's
    # source built without contraction matches plain on such a heap at
    # the physics tests' bars (tests/test_torch_characters.py::
    # test_host_kernel_matches_plain_on_the_landed_heap).
    plain_set = PhysicsSettings(frame_rate=entry_mod.RAGDOLL_FRAME_RATE,
                                fused_substep="off", solver_backend="plain")
    dt = 1.0 / entry_mod.RAGDOLL_FRAME_RATE
    errs = dict.fromkeys(("pos", "rot", "vel", "omega"), 0.0)
    down = torch.tensor([0.0, 1.0, 0.0], device=dev)
    low0 = entry_mod.fitted_lowest(fitted, arch.local_cog.cpu(),
                                   dstate.pos[0].cpu(), dstate.rot[0].cpu())
    pose0 = dstate.pos[:1] - (low0 + 0.02) * down
    touch = dstate.replace(
        pos=pose0.expand_as(dstate.pos).contiguous(),
        rot=dstate.rot[:1].expand_as(dstate.rot).contiguous(),
        vel=(-down).expand_as(dstate.vel).contiguous(),
        omega=torch.zeros_like(dstate.omega))
    with torch.inference_mode():
        active = int(collide.generate_contacts(arch, touch).active.sum())
        per_state = []
        for s0 in (dstate, touch, st):
            kst, _ = step.physics_step(arch, s0, settings, dt)
            pst, _ = step.physics_step(arch, s0, plain_set, dt)
            per_state.append({k: max_err(getattr(kst, k), getattr(pst, k))
                              for k in errs})
        for k in errs:
            errs[k] = max(per_state[0][k], per_state[1][k])
        if reason is None:
            consts = substep_cuda.pack_consts(arch, settings, dt, {}, 0, dev)
            k_ms = cuda_ms(lambda: wrappers["fused"](st, None, consts), 20)
        else:
            k_ms = cuda_ms(lambda: step.physics_step(arch, st, settings, dt),
                           5)
        pl_ms = cuda_ms(lambda: step.physics_step(arch, st, plain_set, dt), 1)
    if not (errs["pos"] <= POSE_TOL and errs["rot"] <= POSE_TOL
            and errs["vel"] <= VEL_TOL and errs["omega"] <= OMEGA_TOL):
        fail(f"characters: kernel {kernel} disagrees with plain on the "
             f"ragdoll (in the air; pressed into the plane): "
             f"{json.dumps(per_state[:2])}")
    cq = arch.vs_plane_collider.shape[0]
    tables_ = solver_cuda.ColoredSolver(arch, cq, ITERATIONS, "kernel").tables
    r_bound = bound(4 * CHAR_DROP_BATCH * 2 * 19 * pos.shape[1],
                    solve_flop(tables_, CHAR_DROP_BATCH, active, ITERATIONS))
    print(f"characters: fitted ragdoll drop (character_ragdoll_entry, "
          f"{CHAR_DROP_BATCH} scenes, {len(fitted.bodies)} capsules, "
          f"{len(fitted.hinge_joint_ids)} hinges, "
          f"{len(fitted.cone_twist_joint_ids)} cone-twists, the fused "
          f"family: {'yes' if reason is None else 'no: ' + reason}): "
          f"{CHAR_DROP_FRAMES} frames, launches {json.dumps(launches)}, "
          f"finite, lowest body {low:.3f} m, farthest {far:.3f} m | "
          f"{CHAR_DROP_BATCH * (CHAR_DROP_FRAMES - 1) / drop_s:.0f} "
          f"scene-steps/s | kernel {kernel} vs plain on one step, max err "
          f"in the air {json.dumps(per_state[0])}, pressed into the plane "
          f"({active} active plane rows) {json.dumps(per_state[1])} (bounds "
          f"{POSE_TOL} / {VEL_TOL} / {OMEGA_TOL}); the landed heap, no "
          f"bound (knife edge) {json.dumps(per_state[2])} | "
          f"{k_ms:.4f} ms by events, plain step "
          f"{pl_ms:.1f} ms, bound {r_bound[0]:.5f} ({r_bound[1]}) | "
          f"{time.perf_counter() - t_drop:.1f} s; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"launches": counts, "drop_launches": launches, "kernel": kernel,
            "drop_err": max(errs.values()), "drop": dict(
                ms=k_ms, plain_ms=pl_ms, bound=r_bound),
            "groups": {
                "name": "raster_groups", "route": "cuda",
                "source": "d3d12renderer_tpu_torch/csrc/raster.cu",
                "replaces": "d3d12renderer_tpu/ops/raster_pallas.py:329",
                "launches": counts["groups"], "max_abs_err": 0.0,
                "ms": g_ms, "plain_ms": g_plain_ms, "bound_ms": g_bound[0],
                "bound_by": g_bound[1], "library_ms": None}}


def main():
    t_script = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this check runs only on a GPU")
    import d3d12renderer_tpu_torch as port

    if not os.path.abspath(port.__file__).startswith(here + os.sep):
        fail(f"d3d12renderer_tpu_torch comes from {port.__file__}, not from "
             "this checkout")
    from d3d12renderer_tpu_torch.render import bvh as bvh_mod

    # A fresh BVH disk cache: every tree the kernels are held on is built
    # in this run, none read from an earlier one.
    bvh_cache = tempfile.TemporaryDirectory(prefix="chip_smoke_bvh_")
    os.environ[bvh_mod.BVH_CACHE_DIR_ENV] = bvh_cache.name
    from torch.autograd import DeviceType

    from d3d12renderer_tpu_torch import cuda_build
    from d3d12renderer_tpu_torch.entry import entry
    from d3d12renderer_tpu_torch.learning.loco_env import (
        ACTION_SIZE, FRAME_RATE, STATE_SIZE, LocoEnv)
    from d3d12renderer_tpu_torch.physics import solver_cuda, step, substep_cuda
    from d3d12renderer_tpu_torch.physics.builder import SceneBuilder
    from d3d12renderer_tpu_torch.physics.types import BodyState, PhysicsSettings

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    colored = solver_cuda.colored_solve_cuda
    fused_k = substep_cuda.fused_substep_cuda

    def cuda_ms(fn, reps):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        sync()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        sync()
        return start.elapsed_time(end) / reps

    def max_err(a, b):
        return (a - b).abs().max().item()

    WIDTHS = solver_cuda.TEAM_WIDTHS

    def occupancy(blocks_per_sm, team_floats):
        """Per team width: dynamic shared bytes per block, and blocks and
        scenes resident on one SM (the CUDA occupancy calculator)."""
        out = {}
        for width in WIDTHS:
            nbytes = solver_cuda.block_shared_bytes(team_floats(width), width)
            blocks = blocks_per_sm(width, nbytes)
            out[width] = (f"{nbytes} B/block, {blocks} blocks, "
                          f"{blocks * (solver_cuda.WARP // width)} scenes")
        return "per SM by width: " + json.dumps(out)

    # 1. Device.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card)
    print(f"device: torch {torch.__version__} cuda {torch.version.cuda} | "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)

    # 2. Build: one nvcc call, every kernel in one library; the native BVH
    # builder with g++.
    t0 = time.perf_counter()
    lib_path = cuda_build.build_library()
    lib = cuda_build.load_library()
    build_s = time.perf_counter() - t0
    log = (lib_path.parent / "build.log").read_text()
    ptxas = " ".join(l.strip() for l in log.splitlines()
                     if "registers" in l or "spill" in l or "entry" in l)
    print(f"build: {build_s:.1f} s -> {lib_path} | {ptxas}", flush=True)
    print("solver kernels (one per team width): " + " | ".join(
        ptxas_entries(log, "colored_solver_kernel")
        + ptxas_entries(log, "fused_substep_kernel")), flush=True)
    t0 = time.perf_counter()
    host_lib = cuda_build.build_host_library()
    cuda_build.load_host_library()
    host_s = time.perf_counter() - t0
    print(f"ray kernels: {ptxas_summary(log, 'ray_closest_hit_bvh')} | "
          f"{ptxas_summary(log, 'ray_closest_hit_brute')} | native BVH "
          f"builder: {host_s:.1f} s -> {host_lib}", flush=True)
    # The blur has one instance per radius and channel count; the frame's
    # are r = 4 (sigma 1.5) with C = 1 and 3, and r = 3 (sigma 1.0), C = 3.
    print(f"raster and image kernels: {ptxas_summary(log, 'raster_tiles')} | "
          f"{ptxas_summary(log, 'raster_groups')} | "
          + " | ".join(ptxas_entries(log, f"gaussian_blurILi{r}ELi{c}E")[0]
                       for r, c in ((4, 1), (4, 3), (3, 3)))
          + f" | {ptxas_summary(log, 'tonemap')}", flush=True)

    # 3. Colored solver vs plain on the preps of a disturbed batch.
    gen = torch.Generator(device=dev).manual_seed(7)
    unfused = PhysicsSettings(frame_rate=FRAME_RATE, fused_substep="off")
    plain_set = PhysicsSettings(frame_rate=FRAME_RATE, fused_substep="off",
                                solver_backend="plain")
    env = LocoEnv(settings=unfused, device=dev)
    _, st = env.reset(BATCH, gen)
    with torch.inference_mode():
        for _ in range(WARM_STEPS):
            act = torch.rand((BATCH, ACTION_SIZE), generator=gen,
                             device=dev) * 2.0 - 1.0
            _, st, _, _ = env.step(st, act)
        act = torch.rand((BATCH, ACTION_SIZE), generator=gen,
                         device=dev) * 2.0 - 1.0
        sp = step.substep_prep(env.arch, st.bodies, 1.0 / FRAME_RATE,
                               env.settings, env._motor_overrides(act))
        num_pairs = sp.contacts.body_a.shape[0]
        solver = solver_cuda.ColoredSolver(env.arch, num_pairs, ITERATIONS,
                                           "kernel")
        args = (sp.joint_preps, sp.contact_prep, sp.vel1, sp.omega1)
        before = colored.launches
        kv, kw = solver(*args)
        sync()
        if colored.launches != before + 1:
            fail("the colored kernel wrapper did not count exactly one launch")
        pv, pw = solver.plain(*args)
        sync()
        if not (torch.isfinite(kv).all() and torch.isfinite(kw).all()):
            fail("colored kernel output is not finite")
        err_v, err_w = max_err(kv, pv), max_err(kw, pw)
        points = int(sp.contact_prep.pmask.sum().item())
        limits = sum(int((p[k] > 0).sum().item()) for p in sp.joint_preps
                     for k in ("eff_limit", "eff_twist_limit", "eff_swing")
                     if k in p)

        # The kernel alone on a packed buffer at each team width, and the
        # kernel route (pack + kernel); in turns with the plain version.
        prep = solver.pack_prep(sp.joint_preps, sp.contact_prep, BATCH, dev)
        arrays = solver.kernel_arrays(dev)

        def kernel_only(width, vel=sp.vel1, omega=sp.omega1, p=prep):
            return solver_cuda.colored_solve_cuda(
                vel, omega, p, arrays, len(solver.tables),
                solver.num_impulses, ITERATIONS, width)

        width_err = {}
        for width in WIDTHS:
            wv, ww = kernel_only(width)
            width_err[width] = (max_err(wv, pv), max_err(ww, pw))
        plain_ms = [cuda_ms(lambda: solver.plain(*args), 2)]
        width_ms = {width: [] for width in WIDTHS}
        for order in (WIDTHS, WIDTHS[::-1]):
            for width in order:
                width_ms[width].append(
                    cuda_ms(lambda: kernel_only(width), 20))
        route_ms = [cuda_ms(lambda: solver(*args), 20) for _ in range(2)]
        plain_ms.append(cuda_ms(lambda: solver.plain(*args), 2))

        # Ragged batches: every width against the plain version.
        ragged_err = {}
        for n in RAGGED:
            rb = BodyState(*(getattr(st.bodies, f)[:n] for f in BODY_FIELDS))
            rsp = step.substep_prep(env.arch, rb, 1.0 / FRAME_RATE,
                                    env.settings, env._motor_overrides(act[:n]))
            rargs = (rsp.joint_preps, rsp.contact_prep, rsp.vel1, rsp.omega1)
            rpv, rpw = solver.plain(*rargs)
            rprep = solver.pack_prep(rsp.joint_preps, rsp.contact_prep, n, dev)
            for width in WIDTHS:
                rv, rw = kernel_only(width, rsp.vel1.contiguous(),
                                     rsp.omega1.contiguous(), rprep)
                ragged_err[(n, width)] = (max_err(rv, rpv), max_err(rw, rpw))
        sync()
    # Bound: the packed prep read once, vel/omega in and out; the solve's
    # operations at this batch's active contact points.
    colored_bound = profiling.solve_bound(prep.numel(), sp.vel1.numel(),
                                          solver.tables, BATCH, points,
                                          ITERATIONS)
    print(f"colored kernel vs plain (B={BATCH}, {ITERATIONS} iterations, "
          f"{points} active contact points, {limits} active limit rows, team "
          f"width {solver_cuda.TEAM_WIDTH}): max |dvel| {err_v:.3e} (bound "
          f"{VEL_TOL}), max |domega| {err_w:.3e} (bound {OMEGA_TOL}); every "
          f"width, max err {json.dumps(width_err)}; ragged (B, W): "
          f"{json.dumps({f'{n}/{w}': e for (n, w), e in ragged_err.items()})}"
          f" | ms per solve: kernel by width "
          f"{json.dumps(width_ms)}, pack + kernel {route_ms}, plain "
          f"{plain_ms}, bound {colored_bound[0]:.4f} ({colored_bound[1]}) | "
          + occupancy(
              lib.colored_solver_blocks_per_sm,
              lambda width: solver_cuda.colored_team_floats(
                  sp.vel1.shape[1], prep.shape[1], solver.num_impulses,
                  width)) + f" | {card}", flush=True)
    if not (err_v <= VEL_TOL and err_w <= OMEGA_TOL):
        fail("the colored kernel disagrees with its plain version")
    for what, errs in (("a team width", width_err),
                       ("a ragged batch", ragged_err)):
        if not all(ev <= VEL_TOL and ew <= OMEGA_TOL
                   for ev, ew in errs.values()):
            fail(f"the colored kernel disagrees with its plain version at "
                 f"{what}: {errs}")

    # 4. Fused kernel vs its plain version: one whole env step from the state
    # after the warm steps, with the same smoothed action and poke.
    fenv = LocoEnv(device=dev)              # the JAX env's settings: fused
    penv = LocoEnv(settings=plain_set, device=dev)
    with torch.inference_mode():
        smoothed = st.last_action + 0.1 * (act - st.last_action)
        bodies = env.apply_poke(st.bodies, *env.draw_poke(gen, BATCH))
        fused = fenv._fused_step
        if fused is None:
            fail("the fused route was not built on the card")
        before = fused_k.launches
        got = fused(bodies, smoothed)
        sync()
        if fused_k.launches != before + 1:
            fail("the fused kernel wrapper did not count exactly one launch")
        want = penv._step_core(bodies, smoothed)       # plain version
        route = env._step_core(bodies, smoothed)       # unfused kernel route
        sync()

        def compare(a, b):
            """Max errors over the envs whose `done` agrees (a flipped env
            resets on one side only), the number of flips, and whether a
            flip lies outside the band around 1 m."""
            (ab, aobs, arew, adone), (bb, bobs, brew, bdone) = a, b
            same = adone == bdone
            errs = {f: max_err(getattr(ab, f)[same], getattr(bb, f)[same])
                    for f in ("pos", "rot", "vel", "omega")}
            errs.update(obs=max_err(aobs[same], bobs[same]),
                        reward=max_err(arew[same], brew[same]))
            # The head height before the reset: the plain side's where it
            # did not fall, else the kernel side's.
            head = torch.where(bdone, ab.pos[:, fenv.part_idx[fenv._head], 1],
                               bb.pos[:, fenv.part_idx[fenv._head], 1])
            near = (head - 1.0).abs() <= DONE_BAND
            return errs, int((~same).sum()), bool((~same & ~near).any())

        f_errs, f_flips, f_bad = compare(got, want)
        r_errs, r_flips, r_bad = compare(got, route)
        finite = all(bool(torch.isfinite(x).all()) for x in
                     (got[0].pos, got[0].rot, got[0].vel, got[0].omega,
                      got[1], got[2]))
        # The kernel alone, on the constants the route packs.
        ovr = smoothed.contiguous()
        fconsts = substep_cuda.pack_consts(
            fenv.arch, fenv.settings, 1.0 / FRAME_RATE, fenv._action_columns(),
            ACTION_SIZE, dev)
        post = fenv.post_consts()

        def fused_width(b, smooth, width):
            """The kernel at team width `width`, as the env step's tuple."""
            nb, extra = fused_k(b, smooth.contiguous(), fconsts, post, width)
            return (nb, extra[:, :STATE_SIZE], extra[:, STATE_SIZE],
                    extra[:, STATE_SIZE + 1] > 0.5)

        # Every width against the plain version, at B and at ragged B.
        checks = {f"{BATCH}/{width}": compare(fused_width(bodies, smoothed,
                                                          width), want)
                  for width in WIDTHS}
        for n in RAGGED:
            rb = BodyState(*(getattr(bodies, f)[:n] for f in BODY_FIELDS))
            rwant = penv._step_core(rb, smoothed[:n])
            for width in WIDTHS:
                checks[f"{n}/{width}"] = compare(
                    fused_width(rb, smoothed[:n], width), rwant)
        sync()

        fw_ms = {width: [] for width in WIDTHS}
        for width in WIDTHS:
            fw_ms[width].append(cuda_ms(
                lambda: fused_k(bodies, ovr, fconsts, post, width), 20))
        u_ms = [cuda_ms(lambda: env._step_core(bodies, smoothed), 10)]
        p_ms = [cuda_ms(lambda: penv._step_core(bodies, smoothed), 1)]
        p_ms.append(cuda_ms(lambda: penv._step_core(bodies, smoothed), 1))
        u_ms.append(cuda_ms(lambda: env._step_core(bodies, smoothed), 10))
        for width in WIDTHS[::-1]:
            fw_ms[width].append(cuda_ms(
                lambda: fused_k(bodies, ovr, fconsts, post, width), 20))
        f_ms = fw_ms[solver_cuda.TEAM_WIDTH]
        # Bound: body state in and out, the action in, obs/reward/done out;
        # the solve's operations at this step's active contact points (the
        # narrowphase, prep and post stage are left out: a lower bound).
        fsp = step.substep_prep(fenv.arch, bodies, 1.0 / FRAME_RATE,
                                fenv.settings, fenv._motor_overrides(smoothed))
        f_points = int(fsp.contact_prep.pmask.sum().item())
        fused_bound = profiling.env_step_bound(
            BATCH, bodies.pos.shape[1], ACTION_SIZE, STATE_SIZE,
            solver.tables, f_points, ITERATIONS)
    print(f"fused kernel vs plain (B={BATCH}, one env step, {ITERATIONS} "
          f"iterations, team width {solver_cuda.TEAM_WIDTH}): max err "
          f"{json.dumps(f_errs)}, done flips {f_flips}; "
          f"vs the unfused kernel route: {json.dumps(r_errs)}, done flips "
          f"{r_flips}; every B/width vs plain (max err, flips): "
          f"{json.dumps({k: [max(e.values()), n] for k, (e, n, _) in checks.items()})}"
          f" | bounds pos/rot {POSE_TOL} vel {VEL_TOL} omega "
          f"{OMEGA_TOL} obs/reward "
          f"{OBS_TOL}, done within {DONE_BAND} of 1 m | ms per env step: "
          f"fused kernel by width {json.dumps(fw_ms)}, unfused kernel route "
          f"{u_ms}, plain {p_ms} | " + occupancy(
              lib.fused_substep_blocks_per_sm,
              lambda width: substep_cuda.fused_team_floats(
                  bodies.pos.shape[1], fconsts.planes, fconsts.num_impulses,
                  width)) + f" | {card}", flush=True)
    for errs, bad, what in ((f_errs, f_bad, "its plain version"),
                            (r_errs, r_bad, "the unfused kernel route"),
                            *((e, b, f"its plain version at B/width {k}")
                              for k, (e, _, b) in checks.items())):
        if not (finite and errs["pos"] <= POSE_TOL and errs["rot"] <= POSE_TOL
                and errs["vel"] <= VEL_TOL and errs["omega"] <= OMEGA_TOL
                and errs["obs"] <= OBS_TOL and errs["reward"] <= OBS_TOL
                and not bad):
            fail(f"the fused kernel disagrees with {what}")
    fused_err = max(f_errs.values())

    # 5. The chain archetype (distance, ball, fixed, hinge; sphere and box
    # colliders): one substep through physics_substep, fused kernel vs the
    # unfused kernel route vs the plain route.
    arch, s0 = chain_scene(SceneBuilder())
    cs = BodyState(*(getattr(s0, f).expand((BATCH,) + getattr(s0, f).shape[1:])
                     .contiguous() for f in ("pos", "rot", "vel", "omega",
                                             "force", "torque")))
    cgen = torch.Generator(device=dev).manual_seed(3)
    moving = (arch.inv_mass[:-1] > 0)[None, :, None]
    cs = cs.replace(
        vel=(torch.rand(cs.vel.shape, generator=cgen, device=dev) - 0.5) * moving,
        omega=(torch.rand(cs.omega.shape, generator=cgen, device=dev) - 0.5)
        * moving)
    chain = {}
    with torch.inference_mode():
        for name, settings in (
                ("fused", PhysicsSettings(frame_rate=FRAME_RATE)),
                ("kernel", unfused), ("plain", plain_set)):
            f0, c0 = fused_k.launches, colored.launches
            out, contacts = step.physics_substep(arch, cs, 1.0 / FRAME_RATE,
                                                 settings)
            sync()
            chain[name] = (out, fused_k.launches - f0, colored.launches - c0)
    if [chain[k][1:] for k in ("fused", "kernel", "plain")] != [
            (1, 0), (0, 1), (0, 0)]:
        fail(f"chain routes took the wrong kernels: "
             f"{[chain[k][1:] for k in chain]}")
    c_errs = {}
    for a, b in (("fused", "plain"), ("kernel", "plain"), ("fused", "kernel")):
        c_errs[f"{a}-{b}"] = {f: max_err(getattr(chain[a][0], f),
                                         getattr(chain[b][0], f))
                              for f in ("pos", "rot", "vel", "omega")}
    print(f"chain (distance, ball, fixed, hinge; B={BATCH}, one substep): "
          f"{json.dumps(c_errs)} | bounds pos/rot {POSE_TOL} vel {VEL_TOL} "
          f"omega {OMEGA_TOL}", flush=True)
    for name, e in c_errs.items():
        if not (e["pos"] <= POSE_TOL and e["rot"] <= POSE_TOL
                and e["vel"] <= VEL_TOL and e["omega"] <= OMEGA_TOL):
            fail(f"chain: {name} disagree")
    colored_err = max(err_v, err_w, c_errs["kernel-plain"]["vel"],
                      c_errs["kernel-plain"]["omega"])
    fused_err = max(fused_err, c_errs["fused-plain"]["vel"],
                    c_errs["fused-plain"]["omega"])

    # 6. Small-input reference: the fused route on the card against the CPU
    # path (the fused route's plain version there), which the CPU tests hold
    # against JAX.  Swing targets of +-1 rad keep the swing motors out of
    # their acos-near-1 regime, where one ulp becomes ~3e-4 rad.
    small = 8
    cpu_env = LocoEnv(device="cpu")
    rng = torch.Generator().manual_seed(3)
    acts = torch.rand((REF_STEPS, small, ACTION_SIZE), generator=rng) - 0.5
    acts[..., 1:21:3] = torch.where(
        torch.rand((REF_STEPS, small, 7), generator=rng) < 0.5, -1.0, 1.0)
    pokes = [(torch.arange(small) == t, torch.full((small,), t),
              torch.full((small,), 0.5 * t)) for t in range(REF_STEPS)]
    _, gst = fenv.reset(small, gen)
    _, cst = cpu_env.reset(small, torch.Generator())
    ref_err = 0.0
    before = fused_k.launches
    with torch.inference_mode():
        for t in range(REF_STEPS):
            gobs, gst, grew, gdone = fenv.step(
                gst, acts[t].to(dev), poke=tuple(x.to(dev) for x in pokes[t]))
            cobs, cst, crew, cdone = cpu_env.step(cst, acts[t], poke=pokes[t])
            if not torch.equal(gdone.cpu(), cdone):
                fail(f"step {t}: done differs between card and CPU")
            ref_err = max(ref_err, max_err(gobs.cpu(), cobs),
                          max_err(grew.cpu(), crew))
    if fused_k.launches != before + REF_STEPS:
        fail("the reference run did not go through the fused kernel")
    print(f"reference: {small} envs x {REF_STEPS} steps, card (fused kernel) "
          f"vs CPU (plain): max |dobs|, |dreward| {ref_err:.3e} (bound "
          f"{REF_TOL})", flush=True)
    if not ref_err <= REF_TOL:
        fail("the card's env step disagrees with the CPU path")

    # 7. Main path: policy forward + env step, one fused launch per step.
    def drive(steps, **kw):
        fn, (model, est, obs) = entry(device=dev, batch=BATCH, seed=0, **kw)
        fn(model, est, obs)   # warm-up (allocator, first launches, consts)
        sync()
        fused_k.launches = colored.launches = 0
        t0 = time.perf_counter()
        with torch.inference_mode():
            any_done = torch.zeros(BATCH, dtype=torch.bool, device=dev)
            finite = torch.ones((), dtype=torch.bool, device=dev)
            for _ in range(steps):
                obs, est, reward, done = fn(model, est, obs)
                any_done |= done
                finite &= torch.isfinite(obs).all() & torch.isfinite(reward).all()
        sync()
        secs = time.perf_counter() - t0
        counts = (fused_k.launches, colored.launches)
        b = est.bodies
        finite = bool(finite) and all(bool(torch.isfinite(x).all()) for x in
                                      (b.pos, b.rot, b.vel, b.omega))
        if obs.shape != (BATCH, STATE_SIZE) or reward.shape != (BATCH,):
            fail(f"bad output shapes {tuple(obs.shape)} {tuple(reward.shape)}")
        if not finite:
            fail(f"non-finite outputs on the path {kw or 'fused'}")
        return BATCH * steps / secs, counts, int(any_done.sum()), (fn, model,
                                                                   est, obs)

    sps, (f_launch, c_launch), fell, (fn, model, est, obs) = drive(MAIN_STEPS)
    if f_launch != MAIN_STEPS or c_launch != 0:
        fail(f"main path: {f_launch} fused and {c_launch} colored launches in "
             f"{MAIN_STEPS} steps (want {MAIN_STEPS} and 0)")
    u_sps, (uf, u_launch), u_fell, _ = drive(UNFUSED_STEPS, fused_substep="off")
    if u_launch != UNFUSED_STEPS or uf != 0:
        fail(f"unfused route: {uf} fused and {u_launch} colored launches in "
             f"{UNFUSED_STEPS} steps")
    p_sps, (pf, pc), _, _ = drive(PLAIN_STEPS, solver_backend="plain")
    if pf or pc:
        fail("the plain route launched a kernel")

    # Device time per step of the fused main path, and kernels per step.
    with torch.inference_mode(), torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            obs, est, _, _ = fn(model, est, obs)
        sync()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / PROFILE_STEPS
    step_ms = 1e3 * BATCH / sps
    fused_dev = [e for e in kernels if "fused_substep" in e.name]
    print(f"main path: {MAIN_STEPS} steps x {BATCH} envs, fused launches "
          f"{f_launch}, colored launches {c_launch}, finite, {fell} envs fell "
          f"and reset | env-steps/s fused {sps:.0f}, unfused kernel route "
          f"{u_sps:.0f} ({u_launch} colored launches in {UNFUSED_STEPS} "
          f"steps, {u_fell} fell), plain {p_sps:.0f} | profiler over "
          f"{PROFILE_STEPS} fused steps: {len(kernels) / PROFILE_STEPS:.1f} "
          f"kernels per step, device busy {dev_ms:.3f} ms per step of "
          f"{step_ms:.3f} ms wall ({100 * dev_ms / step_ms:.1f}%), fused "
          f"kernel {sum(e.time_range.elapsed_us() for e in fused_dev) / 1e3 / max(1, len(fused_dev)):.3f} "
          f"ms each | {card}", flush=True)

    # 8. Standing check through the fused route: zero action, no pokes, no
    # env falls in 1 s.
    no_poke = (torch.zeros(BATCH, dtype=torch.bool, device=dev),
               torch.zeros(BATCH, dtype=torch.int64, device=dev),
               torch.zeros(BATCH, device=dev))
    _, st = fenv.reset(BATCH, gen)
    zero = torch.zeros((BATCH, ACTION_SIZE), device=dev)
    fell = torch.zeros(BATCH, dtype=torch.bool, device=dev)
    before = fused_k.launches
    with torch.inference_mode():
        for _ in range(STAND_STEPS):
            _, st, reward, done = fenv.step(st, zero, poke=no_poke)
            fell |= done
    mean_reward = reward.mean().item()
    print(f"standing (fused): {STAND_STEPS} steps, zero action, no pokes: "
          f"{int(fell.sum())} envs fell, mean reward {mean_reward:.4f}",
          flush=True)
    if fused_k.launches != before + STAND_STEPS:
        fail("the standing check did not go through the fused kernel")
    if bool(fell.any()) or not mean_reward > 0.5:
        fail("the ragdolls did not stand")

    # Seconds per phase (host clock), printed before the total.
    phase_s = {"build, kernels and locomotion": time.perf_counter()
               - t_script}

    def timed(name, phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        phase_s[name] = time.perf_counter() - t0
        return out

    pairs = timed("collision_physics", collision_physics, card, cuda_ms,
                  max_err)
    rays = timed("path_tracing", path_tracing, card, cuda_ms)
    images = timed("raster_frame", raster_frame, card, cuda_ms)
    timed("training", training, card, here)
    dist_launches = timed("distributed_training", distributed_training,
                          card, cuda_ms)
    options = timed("raster_options", raster_options, card, cuda_ms)
    world = timed("showcase_world", showcase_world, card, cuda_ms)
    chars = timed("characters", characters, card, cuda_ms, max_err)
    edit = timed("editor", editor, card, cuda_ms, max_err)
    fly = timed("flythrough", flythrough, card, cuda_ms, max_err)
    # Kernels #3 and #4 on the new paths.
    rays[0]["launches"] += (dist_launches["bvh"] + options["bvh"]
                            + world["launches"]["bvh"])
    rays[1]["launches"] += options["brute"] + world["launches"]["brute"]
    rays[0]["max_abs_err"] = max(rays[0]["max_abs_err"], world["errs"]["bvh"])
    rays[1]["max_abs_err"] = max(rays[1]["max_abs_err"], options["glass_err"],
                                 world["errs"]["brute"])
    # Kernels #5-#7 on the world's frames.
    for row, key in zip(images, ("raster", "tonemap", "blur")):
        row["launches"] += world["launches"][key]
    # The characters' path: #3 in its set-up, #6 and #7 in its frames, #5's
    # group mode, and the ragdoll drop through #2 (or #1); the editor's
    # path: #3 (or #4) for its views and renders, #1 (or #2) for its play
    # frames.
    launch_terms = {"ray_closest_hit_bvh": [rays[0]["launches"]],
                    "ray_closest_hit_brute": [rays[1]["launches"]],
                    "tonemap": [images[1]["launches"]],
                    "gaussian_blur": [images[2]["launches"]]}
    # The shading kernels: the main path's timed frames and the small
    # scene's frame, the sharded frame, the editor's renders, each counted
    # over its own run.
    launch_terms["pt_shade"] = [rays[2]["launches"], dist_launches["shade"],
                                edit["launches"]["shade_hit"]
                                + edit["launches"]["shade_next"]]
    rays[2]["launches"] = sum(launch_terms["pt_shade"])
    rays[0]["launches"] += chars["launches"]["bvh"]
    launch_terms["ray_closest_hit_bvh"].append(chars["launches"]["bvh"])
    for row, key in zip(images[1:], ("tonemap", "blur")):
        row["launches"] += chars["launches"][key]
        launch_terms[row["name"]].append(chars["launches"][key])
    for row, key in zip(rays, ("bvh", "brute")):
        row["launches"] += edit["launches"][key]
        launch_terms[row["name"]].append(edit["launches"][key])
        if key in edit["errs"]:
            row["max_abs_err"] = max(row["max_abs_err"], edit["errs"][key])
    # The flythrough's path: #3 for its cascades, #5 (pair mode), #6 and #7
    # for its frames, #1 for its pile.
    rays[0]["launches"] += fly["launches"]["bvh"]
    launch_terms["ray_closest_hit_bvh"].append(fly["launches"]["bvh"])
    rays[0]["max_abs_err"] = max(rays[0]["max_abs_err"], fly["errs"]["bvh"])
    launch_terms["raster_tiles"] = [images[0]["launches"]]
    for row, key in zip(images, ("raster", "tonemap", "blur")):
        row["launches"] += fly["launches"][key]
        launch_terms[row["name"]].append(fly["launches"][key])
    # Last: run before the blur's profile, its profiles of ~27,000- and
    # ~97,000-kernel frames left that profile seeing 23 of its 50 calls
    # whole.
    timed("runtime_physics", runtime_physics, card)
    terrain_cloth = timed("terrain_and_cloth", terrain_and_cloth, card,
                          cuda_ms, max_err)
    # Kernel #1 on the world's drop (batch 1): the terrain drop's row.
    for row in terrain_cloth:
        if row["name"] == "colored_solver_terrain_drop":
            row["launches"] += world["launches"]["colored"]
            row["max_abs_err"] = max(row["max_abs_err"],
                                     world["errs"]["colored"])

    drop_kernel = "fused_substep" if chars["kernel"] == "fused" else \
        "colored_solver"
    drop_launches = chars["drop_launches"][chars["kernel"]]
    print("kernels line, this phase's launches added: " + "; ".join(
        f"{name} {sum(t)} = {' + '.join(str(x) for x in t)}"
        for name, t in launch_terms.items())
        + f"; {drop_kernel} + {drop_launches} (the ragdoll drop); "
        f"colored_solver + {edit['launches']['colored']}, fused_substep + "
        f"{edit['launches']['fused']} (the editor's play frames); "
        f"colored_solver + {fly['launches']['colored']} (the flythrough); "
        f"raster_groups {chars['groups']['launches']}", flush=True)
    print("seconds per phase: " + ", ".join(f"{k} {v:.1f}"
                                            for k, v in phase_s.items()),
          flush=True)
    print(f"chip_smoke total: {time.perf_counter() - t_script:.1f} s",
          flush=True)
    # Kernel #1's line: this slice's path, the self-colliding locomotion;
    # the plane-only ragdoll's numbers are on phase 3's line.
    colored_extra = (drop_launches if drop_kernel == "colored_solver" else 0
                     ) + edit["launches"]["colored"] + fly["launches"]["colored"]
    fused_extra = (drop_launches if drop_kernel == "fused_substep" else 0
                   ) + edit["launches"]["fused"]
    colored_err = max(colored_err, edit["errs"]["colored"],
                      fly["errs"]["colored"])
    if fused_extra:
        fused_err = max(fused_err, chars["drop_err"])
    else:
        colored_err = max(colored_err, chars["drop_err"])
    print(json.dumps({"kernels": [{
        "name": "colored_solver",
        "route": "cuda",
        "source": "d3d12renderer_tpu_torch/csrc/colored_solver.cu",
        "replaces": "d3d12renderer_tpu/physics/solver_pallas.py:619",
        "launches": pairs["launches"] + colored_extra,
        "max_abs_err": max(colored_err, pairs["max_abs_err"]),
        "ms": pairs["ms"],
        "plain_ms": pairs["plain_ms"],
        "bound_ms": pairs["bound_ms"],
        "bound_by": pairs["bound_by"],
        "library_ms": None,
    }, {
        "name": "fused_substep",
        "route": "cuda",
        "source": "d3d12renderer_tpu_torch/csrc/fused_substep.cu",
        "replaces": "d3d12renderer_tpu/physics/substep_pallas.py:1026",
        "launches": f_launch + fused_extra,
        "max_abs_err": fused_err,
        "ms": min(f_ms),
        "plain_ms": min(p_ms),
        "bound_ms": fused_bound[0],
        "bound_by": fused_bound[1],
        "library_ms": None,
    }] + rays + images + [chars["groups"]] + terrain_cloth}))
    bvh_cache.cleanup()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
