"""The port's main paths: a policy forward plus one batched ragdoll
locomotion env step (counterpart of ``__graft_entry__.entry``), PPO
training, alone and data-parallel over `torch.distributed` (counterpart of
``__graft_entry__.dryrun_multichip``), the path tracer, the raster frame
(plain, with every option of examples/showcase.py, and the Forward+ frame
of 128 point lights), the runtime physics of BASELINE configs 1 (the
1k-body stack drop) and 4 (the gear-train vehicle), terrain physics
(examples/showcase.py's drop with collision events, the triangle-exact
ridge, the vehicle on terrain), cloth against rigid bodies (BASELINE
config 3), examples/showcase.py's whole world, examples/flythrough.py's
pile filmed by an orbiting camera, and skinned characters: a crowd in the
raster frame and ragdolls fitted from their skeleton."""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .cuda_build import resolve_device
from .learning.loco_env import ACTION_SIZE, FRAME_RATE, STATE_SIZE, LocoEnv
from .learning.networks import ActorCritic
from .physics.types import PhysicsSettings


def entry(device="cuda", batch: int = 8, seed: int = 0,
          fused_substep: str = "auto", solver_backend: str = "auto",
          self_collision: bool = False):
    """Returns `(fn, (model, env_state, obs))` on `device`, where
    `fn(model, env_state, obs) -> (obs, env_state, reward, done)` runs the
    policy and steps every env with its mean action.  Weights and pokes come
    from torch Generators seeded with `seed + 1` and `seed`.  With the
    defaults (the JAX env's settings) the env step on a CUDA device is one
    fused-kernel launch; `fused_substep="off"` takes the unfused step with
    the colored-solver kernel, and `solver_backend="plain"` its plain
    PyTorch version.  `self_collision=True` (the JAX env's option) adds the
    ragdoll's collider pairs; the fused kernel refuses those, so every env
    step takes the unfused step with the colored-solver kernel."""
    device = resolve_device(device)
    env = LocoEnv(settings=PhysicsSettings(
        frame_rate=FRAME_RATE, fused_substep=fused_substep,
        solver_backend=solver_backend), self_collision=self_collision,
        device=device)
    obs, env_state = env.reset(
        batch, torch.Generator(device=device).manual_seed(seed))
    model = ActorCritic(STATE_SIZE, ACTION_SIZE,
                        generator=torch.Generator().manual_seed(seed + 1))
    model = model.to(device).eval()

    @torch.inference_mode()
    def fn(model, env_state, obs):
        mean, _, _ = model(obs)
        return env.step(env_state, mean)

    return fn, (model, env_state, obs)


def train_entry(device="cuda", envs: int = 4096, rollout: int = 32,
                minibatches: int = 8, epochs: int = 4, seed: int = 0):
    """PPO training on the locomotion env (counterpart of
    `examples/train_locomotion.py:49-70`; BASELINE config 5 at the
    defaults: 4096 envs, rollout 32, 8 minibatches, 4 epochs).  Returns
    `(train_iteration, state)`: `train_iteration(state) -> (state,
    metrics)` runs one rollout and update cycle (`ppo.make_ppo`); the
    state comes from `init(seed)`.  The env takes the JAX env's settings,
    so on a CUDA device every rollout step is one fused-kernel launch."""
    from .learning.ppo import PPOConfig, make_ppo

    env = LocoEnv(device=resolve_device(device))
    config = PPOConfig(num_envs=envs, rollout_steps=rollout,
                       minibatches=minibatches, epochs=epochs)
    init, train_iteration, _ = make_ppo(env, config)
    return train_iteration, init(seed)


def distributed_entry(device="cuda", envs: int = 4096, rollout: int = 32,
                      minibatches: int = 8, epochs: int = 4):
    """Data-parallel PPO on the locomotion env, `envs` envs on every rank
    (BASELINE config 5 per rank at the defaults, as `train_entry`).  Joins
    the default process group (`data_parallel.join_process_group`: the
    ranks of `torchrun`'s RANK / WORLD_SIZE / MASTER_ADDR, each on the card
    of its LOCAL_RANK, or this process alone; NCCL on the card, gloo only
    for `device="cpu"`), or keeps the one the caller joined (with its own
    timeout, say).  Returns `make_distributed_ppo`'s `(init, train,
    policy_apply)`; on a CUDA device every rollout step is one
    fused-kernel launch per rank."""
    from .learning.ppo import PPOConfig
    from .parallel.data_parallel import (join_process_group,
                                         make_distributed_ppo)

    group, device = join_process_group(resolve_device(device))
    config = PPOConfig(num_envs=envs, rollout_steps=rollout,
                       minibatches=minibatches, epochs=epochs)
    return make_distributed_ppo(LocoEnv(device=device), config, group)


# bench.py:392-485 (`bench_physics_scale`): the stack leg steps at 120 Hz
# with 30 solver iterations, the vehicle leg at 60 Hz; both take frames of
# 1/60 s.
PHYSICS_FRAME_DT = 1.0 / 60.0
STACK_FRAME_RATE = 120
VEHICLE_FRAME_RATE = 60
# runtime_gs colors of the stack drop: on the 1k pile at rest the greedy
# claim leaves 796 of 2,156 active rows in the last, unguaranteed color at
# the JAX default of 32 (323 at 64, none at 128), and that color's
# true-mass sweep throws the pile apart, in the JAX package as in the port
# (tools/jax_stack_drop_reference.py).
STACK_GS_COLORS = 128


_BODY_FIELDS = ("pos", "rot", "vel", "omega", "force", "torque")


class _FrameGraph:
    """One frame `frame(state) -> (state, contacts)` captured into a CUDA
    graph for states of one shape.  `run(state, steps)` replays it `steps`
    times from `state` and returns copies of the graph's buffers, so that
    a later replay does not overwrite what the caller holds.  The kernel
    wrappers' launch counts include the replays (`core.graphs.LaunchTally`:
    the launches the capture recorded, added per replay)."""

    def __init__(self, frame, state):
        from .core.graphs import LaunchTally

        self.state = state.replace(**{f: getattr(state, f).clone()
                                      for f in _BODY_FIELDS})
        self.graph = torch.cuda.CUDAGraph()
        self.tally = LaunchTally()
        with self.tally.capturing(), torch.cuda.graph(self.graph):
            out, self.contacts = frame(self.state)
            for f in _BODY_FIELDS:
                getattr(self.state, f).copy_(getattr(out, f))

    def run(self, state, steps):
        from .utils.checkpoint import tree_map

        for f in _BODY_FIELDS:
            getattr(self.state, f).copy_(getattr(state, f))
        for _ in range(steps):
            self.graph.replay()
        self.tally.replayed(steps)
        return tree_map(_copy, self.state), tree_map(_copy, self.contacts)


def _copy(x):
    return x.clone() if isinstance(x, torch.Tensor) else x


def _physics_runner(arch, settings, default_steps=None, overrides=None):
    """`fn(state, steps)` advances every scene by `steps` frames.  A frame
    of these paths launches tens of thousands of small kernels (the
    vehicle's about 95,000, the 1k stack drop's about 27,000) and keeps
    the card busy for a tenth of its host time, so on a CUDA device the
    first frame of a state shape runs eagerly (which fills the step's
    caches and builds its kernels), the next is captured into a CUDA graph
    (`_FrameGraph`) and that graph replays every later frame of that
    shape, the hand-written kernels' launches counted through the
    replays."""
    from .physics.step import physics_step

    def frame(state):
        return physics_step(arch, state, settings, PHYSICS_FRAME_DT,
                            motor_overrides=overrides)

    graphs = {}

    @torch.inference_mode()
    def fn(state, steps=default_steps):
        contacts = None
        key = tuple(getattr(state, f).shape for f in _BODY_FIELDS)
        if state.pos.device.type == "cuda" and steps > 0:
            if key not in graphs:
                state, contacts = frame(state)
                steps -= 1
                graphs[key] = None
            if steps > 0 and graphs[key] is None:
                try:
                    with torch.cuda.device(state.pos.device):
                        graphs[key] = _FrameGraph(frame, state)
                except RuntimeError as e:      # eager from now on
                    torch.cuda.synchronize(state.pos.device)
                    graphs[key] = False
                    fn.failed[key] = str(e)
            if steps > 0 and graphs[key]:
                return graphs[key].run(state, steps)
        for _ in range(steps):
            state, contacts = frame(state)
        return state, contacts

    fn.graphs, fn.failed = graphs, {}
    return fn


def _batched(state, batch: int):
    return state.replace(**{f: getattr(state, f).expand(
        (batch,) + getattr(state, f).shape[1:]).contiguous()
        for f in ("pos", "rot", "vel", "omega", "force", "torque")})


def stack_drop_entry(device="cuda", bodies: int = 1000, batch: int = 8,
                     steps: int = 300, contact_mode: str = "split_jacobi",
                     iterations: int = 30):
    """BASELINE config 1 (counterpart of the stack leg of
    `bench_physics_scale`, `bench.py:392-485`, and of
    `examples/stack_drop_1k.py`): `bodies` boxes and spheres dropped onto a
    plane, `batch` copies of the scene, the runtime sweep-and-prune
    broadphase, contacts in `contact_mode` ("split_jacobi" or
    "runtime_gs" with STACK_GS_COLORS colors), 120 Hz substeps with
    `iterations` solver iterations (30, bench.py's).

    Returns `(fn, (arch, state))`: `fn(state, steps=steps) -> (state,
    contacts)` advances every scene by `steps` frames of 1/60 s (two
    substeps each) and returns the last substep's contact table."""
    from .models.scenes import STACK_DROP_1K_FINALIZE, add_stack_drop_1k
    from .physics.builder import SceneBuilder

    device = resolve_device(device)
    b = SceneBuilder()
    add_stack_drop_1k(b, bodies)
    arch, state = b.finalize(device=device, **STACK_DROP_1K_FINALIZE)
    settings = PhysicsSettings(frame_rate=STACK_FRAME_RATE,
                               solver_iterations=iterations,
                               contact_mode=contact_mode,
                               runtime_gs_colors=STACK_GS_COLORS)
    return _physics_runner(arch, settings, steps), (arch,
                                                    _batched(state, batch))


def vehicle_entry(device="cuda", batch: int = 8, steps: int = 100,
                  throttle=10.0):
    """BASELINE config 4 (counterpart of the vehicle leg of
    `bench_physics_scale`, `bench.py:392-485`): the 16-part gear-train
    vehicle at (0, 0.85, 0) on a plane of friction 1, `batch` copies,
    split-Jacobi contacts at 60 Hz, the motor hinge driven at `throttle`
    rad/s (one value, or one per scene) and the steering wheel held
    straight.

    Returns `(fn, (arch, info, state))`: `fn(state, steps=steps) ->
    (state, contacts)` advances every scene by `steps` frames of 1/60 s;
    `info` names the vehicle's bodies (`models.vehicle.VehicleInfo`)."""
    from .models.vehicle import build_vehicle, drive_overrides
    from .physics.builder import SceneBuilder

    device = resolve_device(device)
    b = SceneBuilder()
    b.add_static_plane((0.0, 1.0, 0.0), 0.0, friction=1.0)
    info = build_vehicle(b, position=(0.0, 0.85, 0.0))
    arch, state = b.finalize(device=device)
    overrides = drive_overrides(arch, info, throttle_velocity=throttle,
                                steering_angle=0.0, batch=batch)
    settings = PhysicsSettings(frame_rate=VEHICLE_FRAME_RATE,
                               contact_mode="split_jacobi")
    return (_physics_runner(arch, settings, steps, overrides),
            (arch, info, _batched(state, batch)))


# examples/showcase.py:129-133: frames of 1/60 s in 2 substeps of the
# default settings (120 Hz, colored contacts).
TERRAIN_FRAME_DT = 1.0 / 60.0
TERRAIN_SUBSTEPS = 2
TERRAIN_SCENES = ("drop", "ridge")


def terrain_entry(device="cuda", batch: int = 4096, scene: str = "drop"):
    """Rigid bodies on a heightfield, `batch` copies, the default settings
    (120 Hz, 30 iterations, colored contacts: the colored-solver kernel on
    CUDA tensors), collision events collected per substep as
    examples/showcase.py's `--audio` path does.

    scene "drop" (examples/showcase.py:86-147): 6 boxes and spheres dropped
    onto its 65 x 65 heightmap, bilinear terrain rows.  scene "ridge"
    (tests/test_heightmap_mip.py:138-161): a wide flat box dropped on a
    ridge's crest, `terrain_collision="triangles"` (the mip descent, vertex
    tests and GJK / EPA per candidate triangle).

    Returns `(fn, (arch, state))`: `fn(state, prev_active=None) -> (state,
    contacts, events)` advances every scene by one frame of 1/60 s (2
    substeps); pass the events' `active` back as `prev_active`."""
    from .models import scenes
    from .physics.builder import SceneBuilder
    from .physics.step import physics_step

    if scene not in TERRAIN_SCENES:
        raise ValueError(f"scene must be one of {TERRAIN_SCENES}, not "
                         f"{scene!r}")
    device = resolve_device(device)
    b = SceneBuilder()
    if scene == "drop":
        scenes.add_terrain_drop(b, scenes.terrain_drop_heights())
        arch, state = b.finalize(device=device)
    else:
        scenes.add_ridge(b)
        arch, state = b.finalize(device=device,
                                 terrain_collision="triangles")
    settings = PhysicsSettings()

    @torch.inference_mode()
    def fn(state, prev_active=None):
        return physics_step(arch, state, settings, TERRAIN_FRAME_DT,
                            num_substeps=TERRAIN_SUBSTEPS,
                            collect_events=True, prev_active=prev_active)

    return fn, (arch, _batched(state, batch))


def cloth_entry(device="cuda", grid: int = 32, batch: int = 256):
    """BASELINE config 3 (cloth grids colliding with rigid spheres and
    capsules; tests/test_cloth.py:87-129's coupled step): a `grid` x `grid`
    cloth, 2 x 2 m, its top row pinned, and a rigid sphere rolling under it
    beside a capsule held in place (`scenes.add_cloth_colliders`), `batch`
    copies.  A frame is one `physics_step` of 1/120 s (the fused kernel
    takes it on CUDA tensors: spheres and capsules on a plane) and one
    `step_cloth_with_bodies` (2 position iterations, margin 0.01).

    Returns `(fn, (arch, body_state, params, cloth_state))`:
    `fn(cloth_state, body_state) -> (cloth_state, body_state)` runs one
    frame."""
    from .models import scenes
    from .physics.builder import SceneBuilder
    from .physics.cloth import create_cloth
    from .physics.cloth_coupling import step_cloth_with_bodies
    from .physics.step import physics_step

    device = resolve_device(device)
    b = SceneBuilder()
    info = scenes.add_cloth_colliders(b)
    arch, state = b.finalize(device=device)
    state.vel[:, info["ball"]] = torch.tensor(scenes.CLOTH_BALL_VEL,
                                              device=device)
    params, cloth = create_cloth(
        scenes.CLOTH_SIZE, scenes.CLOTH_SIZE, grid, grid,
        total_mass=scenes.CLOTH_MASS, damping=scenes.CLOTH_DAMPING,
        device=device)
    cloth = cloth.replace(**{f: getattr(cloth, f).expand(
        (batch,) + getattr(cloth, f).shape).contiguous()
        for f in ("positions", "prev_positions", "velocities", "forces")})
    settings = PhysicsSettings()

    @torch.inference_mode()
    def fn(cloth_state, body_state):
        body_state, _ = physics_step(arch, body_state, settings,
                                     scenes.CLOTH_DT)
        cloth_state = step_cloth_with_bodies(
            params, cloth_state, arch, body_state, scenes.CLOTH_DT,
            position_iterations=scenes.CLOTH_ITERATIONS,
            margin=scenes.CLOTH_MARGIN)
        return cloth_state, body_state

    return fn, (arch, _batched(state, batch), params, cloth)


# examples/vehicle_terrain.py:21: the motor hinge's default target.
VEHICLE_TERRAIN_THROTTLE = 10.0


def vehicle_terrain_entry(device="cuda", batch: int = 8,
                          throttle: float = VEHICLE_TERRAIN_THROTTLE):
    """examples/vehicle_terrain.py's drive: the gear-train vehicle on its
    49 x 49 heightmap (amplitude 1.2, seed 11, friction 1), `batch` copies,
    split-Jacobi contacts at 60 Hz, the motor hinge at `throttle` rad/s,
    steering straight.

    Returns `(fn, (arch, info, state))` as `vehicle_entry`, except that
    `fn(state, steps)` takes its frame count from the caller."""
    from .models import scenes
    from .models.vehicle import build_vehicle, drive_overrides
    from .physics.builder import SceneBuilder

    device = resolve_device(device)
    b = SceneBuilder()
    start = scenes.add_vehicle_terrain(b, scenes.vehicle_terrain_heights())
    info = build_vehicle(b, position=start)
    arch, state = b.finalize(device=device)
    overrides = drive_overrides(arch, info, throttle_velocity=throttle,
                                steering_angle=0.0, batch=batch)
    settings = PhysicsSettings(frame_rate=VEHICLE_FRAME_RATE,
                               contact_mode="split_jacobi")
    return (_physics_runner(arch, settings, overrides=overrides),
            (arch, info, _batched(state, batch)))


# bench.py:358-365: floor, column stone, trim, balustrade, fountain metal,
# cloth banners.
ATRIUM_ALBEDO = [[0.55, 0.5, 0.45], [0.7, 0.66, 0.6], [0.75, 0.72, 0.65],
                 [0.6, 0.58, 0.52], [0.9, 0.88, 0.85], [0.6, 0.15, 0.12]]
ATRIUM_ROUGHNESS = [0.6, 0.7, 0.55, 0.65, 0.15, 0.8]
ATRIUM_METALLIC = [0.0, 0.0, 0.0, 0.0, 1.0, 0.0]
# bench.py:290: the raster frame's cascades are 512^2 each.
RASTER_SHADOW_RESOLUTION = 512


def _atrium(device, width: int, height: int, meshes=None):
    """`bench_pt_e2e` / `bench_raster_frame`'s set-up (`bench.py:356-372`):
    the 256,798-triangle atrium (`atrium_scene(1.4)`, or `meshes` with its
    material ids) with its six materials under `default_sky()`, seen by
    `look_at((8, 6, -14), (0, 3, 0))` at 60 degrees and width/height
    aspect.  (scene, camera)."""
    import math

    from .render import bvh as bvh_mod
    from .render import pathtracer as pt
    from .render.camera import look_at
    from .render.mesh import atrium_scene

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    meshes = atrium_scene(1.4) if meshes is None else meshes
    bvh = bvh_mod.build_bvh(meshes, device=device)
    materials = pt.Materials(albedo=f32(ATRIUM_ALBEDO),
                             emissive=torch.zeros((6, 3), device=device),
                             roughness=f32(ATRIUM_ROUGHNESS),
                             metallic=f32(ATRIUM_METALLIC))
    scene = pt.Scene(bvh=bvh, materials=materials,
                     sky=pt.default_sky(device=device)).with_shading_table()
    camera = look_at((8.0, 6.0, -14.0), (0.0, 3.0, 0.0), device=device,
                     v_fov=math.radians(60), aspect=width / height)
    return scene, camera


def pathtrace_entry(device="cuda", width: int = 1920, height: int = 1080,
                    recursion_depth: int = 3, seed: int = 0):
    """The path tracer's main path (counterpart of `bench_pt_e2e`'s set-up,
    `bench.py:356-372`): the atrium of `_atrium` with its six materials
    under `default_sky()`.

    Returns `(fn, (scene, camera, sampler))`, where
    `fn(scene, camera, sampler) -> (image (H, W, 3), rays_traced)` renders
    one frame at one sample per pixel, depth `recursion_depth`, with sun NEE
    and MIS; each call draws new numbers from `sampler` (a
    `torch.Generator` seeded with `seed`)."""
    from .render import pathtracer as pt

    device = resolve_device(device)
    scene, camera = _atrium(device, width, height)
    settings = pt.PathTracerSettings(recursion_depth=recursion_depth)
    sampler = pt.Sampler(torch.Generator(device=device).manual_seed(seed))

    @torch.inference_mode()
    def fn(scene, camera, sampler):
        return pt.render(scene, camera, width, height, settings, spp=1,
                         sampler=sampler)

    return fn, (scene, camera, sampler)


def _raster_frames(scene, camera, width: int, height: int, device, seed: int,
                   options: dict):
    """`fn(state, profile_stages=False, jitter=None, **overrides) ->
    (ldr, state, aux)` (with `fn.options`, `fn.scene` and `fn.camera`):
    one `render_frame` of the scene with the raster
    primary and half-res effects, TAA history carried (the previous camera
    is the camera), `options` as its keyword arguments (`overrides`
    replace them for one frame: another `settings`, or an option set to
    None), the sub-pixel jitter drawn from a generator seeded `seed` unless
    given; `scene=` renders another scene with the same maps and probes."""
    from .render.pipeline import RendererSettings, render_frame

    generator = torch.Generator(device=device).manual_seed(seed)
    options = {"settings": RendererSettings(primary="raster",
                                            half_res_effects=True),
               **options}

    @torch.inference_mode()
    def fn(state, profile_stages: bool = False, jitter=None, **overrides):
        if jitter is None:
            jitter = torch.rand(2, generator=generator, device=device)
        kw = {**options, **overrides}
        return render_frame(kw.pop("scene", scene), camera, width, height,
                            kw.pop("settings"),
                            frame_state=state, prev_camera=camera,
                            jitter=jitter, profile_stages=profile_stages,
                            **kw)

    fn.options, fn.scene, fn.camera = options, scene, camera
    return fn


def _sun_maps(scene, camera, resolution: int):
    """The sun's 3 cascades at `resolution`^2, rendered once (static scene
    and sun)."""
    from .render.shadows import fit_cascades, render_sun_shadow_maps

    with torch.inference_mode():
        return render_sun_shadow_maps(
            scene.bvh, fit_cascades(camera.position, -scene.sky.sun_direction),
            resolution=resolution)


def raster_entry(device="cuda", width: int = 1920, height: int = 1080,
                 seed: int = 0):
    """The raster frame's main path (counterpart of `bench_raster_frame`'s
    set-up, `bench.py:265-303`): the atrium, materials and camera of
    `_atrium`, `RendererSettings(primary="raster", half_res_effects=True)`,
    and 3-cascade sun shadow maps of `RASTER_SHADOW_RESOLUTION`^2 rendered
    once here (static scene and sun).

    Returns `(fn, state)`: `state` is the initial `FrameState` and
    `fn(state, profile_stages=False) -> (ldr (H, W, 3), state, aux)`
    renders one frame with TAA history carried (the previous camera is the
    camera: no motion).  Each frame's two sub-pixel jitter floats are drawn
    from a `torch.Generator` seeded with `seed`.  `aux` is
    `render_frame`'s."""
    from .render.pipeline import initial_frame_state

    device = resolve_device(device)
    scene, camera = _atrium(device, width, height)
    fn = _raster_frames(scene, camera, width, height, device, seed,
                        {"shadow_maps": _sun_maps(scene, camera,
                                                  RASTER_SHADOW_RESOLUTION)})
    return fn, initial_frame_state(width, height, device)


# raster_showcase_entry: examples/showcase.py:274-363's options, placed
# where raster_entry's camera sees them: the ground outside the atrium's
# south wall (x in [-14, 3], z in [-12, -8.6]) and the wall's face.
SHOWCASE_ATLAS_SIZE = 4096
SHOWCASE_SPOT = dict(position=(-2.0, 6.0, -13.0), direction=(-2.0, -6.0, 3.5),
                     color=(45.0, 42.0, 38.0), distance=28.0, inner_cos=0.85,
                     outer_cos=0.65)
SHOWCASE_SPOT_RESOLUTION = 256
SHOWCASE_POINT = dict(position=(4.0, 2.5, -11.0), color=(30.0, 22.0, 12.0),
                      radius=16.0)
SHOWCASE_POINT_RESOLUTION = 192
SHOWCASE_PROBES = dict(origin=(-13.5, 0.5, -13.5), extent=(27.0, 6.0, 27.0),
                       dims=(5, 3, 5))
SHOWCASE_PROBE_UPDATES = 2
SHOWCASE_PROBE_RAYS = 32
SHOWCASE_DECAL = dict(positions=[(-4.0, 0.0, -10.0)],
                      rotations=[(0.7071, 0.0, 0.0, 0.7071)],
                      half_extents=[(1.2, 1.2, 2.0)],
                      albedos=[(0.05, 0.05, 0.06)])
SHOWCASE_GLASS_HALF = (1.2, 1.0, 0.08)
SHOWCASE_GLASS_AT = (0.0, 1.2, -10.0)
SHOWCASE_GLASS_COLOR = (0.5, 0.8, 0.7)
SHOWCASE_GLASS_ALPHA = 0.35
SHOWCASE_WATER_HEIGHT = 0.25


def raster_showcase_entry(device="cuda", width: int = 1920, height: int = 1080,
                          seed: int = 0):
    """`raster_entry`'s frame with every option of examples/showcase.py's
    frame (`:274-363`), in the atrium:

    * `enable_sss` and `enable_rt_reflections`;
    * one `ShadowAtlas(4096)` holding the sun's cascades at
      RASTER_SHADOW_RESOLUTION^2, a spot light's 256^2 map and a point
      light's 2 x 192^2 map.  The spot light stands at (-2, 6, -13) and
      points along (-2, -6, 3.5), at the ground near (-4, 0, -9.5) (cone
      cosines 0.65 / 0.85, range 28); the point light stands at (4, 2.5,
      -11), radius 16;
    * a 5 x 3 x 5 probe grid over the atrium's bounds (x, z in [-13.5,
      13.5], y in [0.5, 6.5]), updated twice at 32 rays per probe, the
      rotations drawn from a CPU generator seeded `seed + 1` (the same
      probes on every device);
    * a decal of half extents (1.2, 1.2, 2.0) and albedo (0.05, 0.05,
      0.06) at (-4, 0, -10), projecting straight down;
    * a glass slab, `box((1.2, 1.0, 0.08))` at (0, 1.2, -10), colour (0.5,
      0.8, 0.7), alpha 0.35;
    * water at y = 0.25: the atrium's ground is flat at y = 0, so it covers
      all the ground and the foot of the walls.

    The shadow maps and probes are made once here.  Returns `(fn, state)`
    as `raster_entry`; `fn(state, profile_stages=False, jitter=None,
    **overrides)` takes a frame's jitter or any `render_frame` option in
    place of the entry's (`fn.options` holds them)."""
    from .render.pipeline import initial_frame_state

    device = resolve_device(device)
    scene, camera = _atrium(device, width, height)
    fn = _showcase_frames(scene, camera, width, height, device, seed)
    return fn, initial_frame_state(width, height, device)


def _showcase_frames(scene, camera, width: int, height: int, device,
                     seed: int, map_resolution=None):
    """`raster_showcase_entry`'s frames of `scene`, its maps at the entry's
    sizes or all at `map_resolution`^2 (`fn.atlas` the atlas)."""
    from .render import bvh as bvh_mod
    from .render import mesh
    from .render.decals import make_decals
    from .render.light_probe import create_probe_grid, update_probes
    from .render.lights import make_point_lights, make_spot_lights
    from .render.pipeline import RendererSettings
    from .render.shadows import ShadowAtlas
    from .render.transparent import TransparentObject

    spot, point = SHOWCASE_SPOT, SHOWCASE_POINT
    sun_res, spot_res, point_res = (
        (RASTER_SHADOW_RESOLUTION, SHOWCASE_SPOT_RESOLUTION,
         SHOWCASE_POINT_RESOLUTION) if map_resolution is None
        else (map_resolution,) * 3)
    with torch.inference_mode():
        atlas = ShadowAtlas(SHOWCASE_ATLAS_SIZE, device=device)
        sun_maps = atlas.update_sun(scene.bvh, camera.position,
                                    -scene.sky.sun_direction,
                                    resolution=sun_res)
        spot_map = atlas.update_spot(
            scene.bvh, 0, spot["position"], spot["direction"],
            spot["outer_cos"], spot["distance"], resolution=spot_res)
        point_map = atlas.update_point(
            scene.bvh, 0, point["position"], point["radius"],
            resolution=point_res)
        grid = create_probe_grid(**SHOWCASE_PROBES, device=device)
        # The rotations from a CPU generator: the same on every device.
        turns = torch.rand(SHOWCASE_PROBE_UPDATES,
                           generator=torch.Generator().manual_seed(seed + 1))
        for turn in turns:
            grid = update_probes(grid, scene, rotation=turn,
                                 rays_per_probe=SHOWCASE_PROBE_RAYS)
    glass = TransparentObject(
        bvh=bvh_mod.build_bvh([(mesh.box(SHOWCASE_GLASS_HALF).transformed(
            translate=SHOWCASE_GLASS_AT), 0)], device=device),
        color=SHOWCASE_GLASS_COLOR, alpha=SHOWCASE_GLASS_ALPHA)
    options = dict(
        settings=RendererSettings(primary="raster", half_res_effects=True,
                                  enable_sss=True,
                                  enable_rt_reflections=True),
        shadow_maps=sun_maps,
        point_lights=make_point_lights([point["position"]], [point["color"]],
                                       [point["radius"]], device=device),
        point_shadow_maps=[point_map],
        spot_lights=make_spot_lights(
            [spot["position"]], [spot["direction"]], [spot["color"]],
            [spot["distance"]], [spot["inner_cos"]], [spot["outer_cos"]],
            device=device),
        spot_shadow_maps=[spot_map], probe_grid=grid,
        decals=make_decals(**SHOWCASE_DECAL, device=device),
        transparent_objects=[glass], water_height=SHOWCASE_WATER_HEIGHT)
    fn = _raster_frames(scene, camera, width, height, device, seed, options)
    fn.atlas = atlas
    return fn


# raster_lights_entry: the Forward+ frame.
RASTER_LIGHTS = 128
RASTER_LIGHT_RADIUS = 4.0
# The lights' box: the atrium's ground (x, z in [-14, 14]) up to its walls'
# top (y 6.8), from 0.3 above the ground.
RASTER_LIGHTS_LO = (-14.0, 0.3, -14.0)
RASTER_LIGHTS_HI = (14.0, 6.8, 14.0)


def raster_lights_entry(device="cuda", width: int = 1920, height: int = 1080,
                        seed: int = 0):
    """`raster_entry`'s frame with RASTER_LIGHTS unshadowed point lights of
    radius RASTER_LIGHT_RADIUS, shaded through the Forward+ tile lists
    (`cull_lights_tiled` / `shade_point_lights`): positions uniform in the
    atrium's box (RASTER_LIGHTS_LO to RASTER_LIGHTS_HI) and colours uniform
    in [2, 10) per channel, both from `numpy.random.default_rng(seed)`.
    Returns `(fn, state)` as `raster_showcase_entry`."""
    from .render.pipeline import initial_frame_state

    device = resolve_device(device)
    scene, camera = _atrium(device, width, height)
    fn = _lights_frames(scene, camera, width, height, device, seed,
                        RASTER_SHADOW_RESOLUTION)
    return fn, initial_frame_state(width, height, device)


def _lights_frames(scene, camera, width: int, height: int, device,
                   seed: int, map_resolution: int):
    """`raster_lights_entry`'s frames of `scene`, the sun's cascades at
    `map_resolution`^2."""
    import numpy as np

    from .render.lights import make_point_lights

    rng = np.random.default_rng(seed)
    positions = rng.uniform(RASTER_LIGHTS_LO, RASTER_LIGHTS_HI,
                            (RASTER_LIGHTS, 3))
    colors = rng.uniform(2.0, 10.0, (RASTER_LIGHTS, 3))
    lights = make_point_lights(positions, colors,
                               [RASTER_LIGHT_RADIUS] * RASTER_LIGHTS,
                               device=device)
    return _raster_frames(scene, camera, width, height, device, seed,
                          {"shadow_maps": _sun_maps(scene, camera,
                                                    map_resolution),
                           "point_lights": lights})


def showcase_world_entry(device="cuda", width: int = 1920, height: int = 1080,
                         seed: int = 0, audio: Optional[str] = None,
                         **world):
    """examples/showcase.py's whole world (`models.world.build_world`,
    built once here): the 65 x 65 terrain in LOD chunks with its splat
    texture, the six bodies settled on it for 180 frames (each substep one
    colored-solver launch on the card), placed trees, grass culled against
    this frame's camera (width / height aspect), the HDR sky from
    examples/data/studio.hdr through the image cache and a 128^2 cubemap,
    one 4096 shadow atlas (sun 384, spot 256, point 192), 5 x 3 x 5 probes
    updated twice at 32 rays, a decal, a glass slab, water at 0.9, and 256
    fire particles stepped 45 times.  `world` goes to `build_world`:
    `config` (a `WorldConfig`), `envmap` (None: the procedural sky),
    `draws`, `heights`.  `audio` (a WAV path) runs the drop with collision
    events, as examples/showcase.py's `--audio` does, and writes its
    impacts' mixdown there (`world.write_impact_audio`); `fn.audio` then
    holds {"path", "impacts", "seconds"}.

    Returns `(fn, state)`: `fn(state, profile_stages=False, jitter=None,
    **overrides) -> (ldr, state, aux)` renders one frame (raster primary,
    half-res effects, SSS, RT reflections, every light, map, probe, decal,
    glass and water) and adds the fire particles onto the tonemapped frame
    (`particles.systems.splat_particles`); `aux["frame_ldr"]` is the frame
    before the splat.  `fn.world` holds the world, `fn.options` the frame's
    options."""
    from .models.world import (PARTICLE_COLOR, WorldConfig, build_world,
                               write_impact_audio)
    from .particles.systems import splat_particles
    from .render.pipeline import initial_frame_state

    device = resolve_device(device)
    frames = world.get("config", WorldConfig()).physics_frames
    world = build_world(device, width, height, seed,
                        collect_events=audio is not None, **world)
    sound = None
    if audio is not None:
        sound = {"path": audio, "impacts": world.impacts,
                 "seconds": write_impact_audio(world.impacts, audio,
                                               frames)}
    frame = _raster_frames(world.scene, world.camera, width, height, device,
                           seed, world.options)
    color = torch.tensor(PARTICLE_COLOR, device=device)

    @torch.inference_mode()
    def fn(state, profile_stages: bool = False, jitter=None, **overrides):
        ldr, state, aux = frame(state, profile_stages=profile_stages,
                                jitter=jitter, **overrides)
        fire = world.fire
        aux["frame_ldr"] = ldr
        return (splat_particles(ldr, world.camera, fire.position, fire.alive,
                                color), state, aux)

    fn.world, fn.options = world, world.options
    fn.scene, fn.camera = world.scene, world.camera
    fn.audio = sound
    return fn, initial_frame_state(width, height, device)


# examples/flythrough.py:79-104: the pile's render meshes (box, sphere, a
# 24 m ground quad), materials (ground, spheres, boxes), the one point
# light, the cascades' resolution and the orbit of `flythrough_camera`.
FLYTHROUGH_ALBEDO = [[0.45, 0.45, 0.45], [0.75, 0.22, 0.16], [0.2, 0.38, 0.8]]
FLYTHROUGH_ROUGHNESS = [0.75, 0.45, 0.25]
FLYTHROUGH_LIGHT = dict(positions=[[3.0, 2.5, 3.0]], colors=[[30.0, 12.0, 6.0]],
                        radii=[9.0])
FLYTHROUGH_SHADOW_RESOLUTION = 256
FLYTHROUGH_GROUND_HALF = 12.0
FLYTHROUGH_SPHERE_SUBDIV = 2
FLYTHROUGH_FRAME_DT = 1.0 / 60.0
FLYTHROUGH_SUBSTEPS = 2
# Frames of physics alone before the filmed ones: the lowest body meets
# the plane at frame ~30 and the column lands over frames 30-110, so at
# frame 60 bodies rest, slide and fall onto each other (contact rows
# active) while the top of the column is still in the air.
FLYTHROUGH_SETTLE_FRAMES = 60
# examples/flythrough.py:65: the pile's numpy seed.
FLYTHROUGH_PILE_SEED = 4


@dataclass
class FlythroughWorld:
    """examples/flythrough.py's set-up: the pile's archetype, its initial
    state and body kinds, the instanced render meshes (instance i is body
    i, the last the ground), materials, sky and light."""

    arch: object
    state: object
    kinds: list
    instances: object
    materials: object
    sky: object
    lights: object


def flythrough_world(device="cuda",
                     pile_seed: int = FLYTHROUGH_PILE_SEED) -> FlythroughWorld:
    """examples/flythrough.py:58-104 on `device`, the bodies' x and z drawn
    from `pile_seed` (`models.scenes.add_flythrough_pile`)."""
    from .models.scenes import (FLYTHROUGH_BOX_HALF, FLYTHROUGH_SPHERE_RADIUS,
                                add_flythrough_pile)
    from .physics.builder import SceneBuilder
    from .render import mesh as mesh_mod
    from .render import pathtracer as pt
    from .render.instances import build_instanced
    from .render.lights import make_point_lights

    device = resolve_device(device)
    b = SceneBuilder()
    kinds = add_flythrough_pile(b, pile_seed)
    arch, state = b.finalize(device=device)
    meshes = [(mesh_mod.box((FLYTHROUGH_BOX_HALF,) * 3), 1),
              (mesh_mod.ico_sphere(FLYTHROUGH_SPHERE_RADIUS,
                                   FLYTHROUGH_SPHERE_SUBDIV), 2),
              (mesh_mod.quad(half=FLYTHROUGH_GROUND_HALF), 0)]
    instances = build_instanced(
        meshes, [0 if k == "box" else 1 for k in kinds] + [2], device=device)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    materials = pt.Materials(albedo=f32(FLYTHROUGH_ALBEDO),
                             emissive=torch.zeros((3, 3), device=device),
                             roughness=f32(FLYTHROUGH_ROUGHNESS),
                             metallic=torch.zeros(3, device=device))
    return FlythroughWorld(arch, state, kinds, instances, materials,
                           pt.default_sky(device=device),
                           make_point_lights(**FLYTHROUGH_LIGHT,
                                             device=device))


def flythrough_camera(f: int, frames: int, width: int, height: int,
                      device="cuda"):
    """examples/flythrough.py:118-124: frame `f` of `frames` on one orbit
    of radius 6.5 m around (0, 0.9, 0), bobbing between 1.4 and 3.8 m."""
    from .render.camera import look_at

    th = 2 * math.pi * f / max(frames, 1)
    eye = (6.5 * math.cos(th), 2.6 + 1.2 * math.sin(2 * th),
           6.5 * math.sin(th))
    return look_at(eye, (0.0, 0.9, 0.0), device=device, aspect=width / height,
                   v_fov=math.radians(48))


@dataclass
class GameState:
    """What the game frame carries from frame to frame: the pile's bodies
    (batch 1), the raster frame's temporal state, the filmed frames so far
    (the camera's place on its orbit) and the previous frame's camera
    (None before the first: TAA's motion vectors then see no motion)."""

    bodies: object
    frame_state: object
    frame: int = 0
    prev_camera: object = None


def flythrough_entry(device="cuda", width: int = 1920, height: int = 1080,
                     frames: int = 16,
                     settle_frames: int = FLYTHROUGH_SETTLE_FRAMES,
                     seed: int = 0, jitters=None, state=None,
                     shadow_resolution: Optional[int] = None,
                     orbit_frames: Optional[int] = None,
                     pile_seed: int = FLYTHROUGH_PILE_SEED,
                     half_res_effects: bool = False):
    """examples/flythrough.py's path (physics under the raster frame while
    an orbiting camera films it), at the reference editor's 1920x1080 by
    default: `settle_frames` frames of physics alone, then `frames` filmed
    frames of the game frame `fn`.

    The game frame `fn(game, jitter=None, profile_stages=False) -> (ldr,
    game, aux)` takes a `GameState` and does, in order: one physics frame
    of two 120 Hz substeps (colored contacts: the pile's pair rows keep it
    outside the fused kernel's family, so each substep is one
    colored-solver launch on the card), replayed from a CUDA graph after
    the first (`_physics_runner`); the instances posed on the device with
    their tree refitted (`render.instances.retransform(tree=True)`); the
    sun's 3 cascades at `shadow_resolution`^2 (FLYTHROUGH_SHADOW_RESOLUTION
    by default) through the BVH kernel; `render_frame` with the point
    light, TAA history carried and the previous frame's camera as
    `prev_camera`.  On the card the steps after the physics (the tree, the
    cascades, the raster frame) replay from a second CUDA graph from the
    second frame on (`core.graphs.Graphed`, returned as "graphs"); a frame
    with `profile_stages` runs them eagerly.  The camera is frame
    `game.frame` of `flythrough_camera`'s orbit of `orbit_frames` frames a
    turn (`frames` by default), the cameras made once here.  The frame
    takes the raster primary (`RendererSettings(primary="raster")`, as the
    port's other raster paths; JAX's script takes `RendererSettings()`,
    whose primary is "ray").  A jitter not given comes from a generator
    seeded `seed` on the device.  The cascades' error word is read a frame
    late (`ray_trace.DeferredError`) and the raster primary lists the
    pile's pairs in slots for every pair that can exist
    (`ops.raster.bin_pairs`), so the frame never waits for the card on the
    host.

    Spans (`core/profiling.py`, device-timed on the card): `game.frame` >
    `phys.frame` (the physics frame: a graph replay after the first) and,
    in frames with `profile_stages` (eager: a replay holds no timing
    events), `inst.tree` (posing and the tree), `shadow.cascades` (fit and
    query), `raster.frame` (the raster frame, its stages `raster.<stage>`
    inside it); counters `phys.pairs` (the
    contact table's candidate rows a substep: the pile's static pair
    buckets and plane rows), `phys.contact_rows` (active rows, the frame's
    last substep, a 0-d tensor), `shadow.rays`.  With `profile_stages`
    aux holds "stage_ms" (those spans' ms, one wait) and "counts" (the
    counters, and on the card `shadow.rows_tested`: kernel #3's plane
    tests a cascade ray, from its stats, which only such frames collect,
    in a second query of the frame's cascade rays after the spans: the
    counts cost the kernel an atomic add a ray).

    `pile_seed` draws the pile (`flythrough_world`); `state` replaces its
    initial BodyState (batch 1).  `half_res_effects`: AO and SSR at half
    resolution with temporal accumulation (the reference application's
    default; JAX's script renders them at full resolution).

    Returns a dict: "fn", "game" (the GameState after the filmed frames),
    "start" (the GameState after the settling frames), "frames" (each
    filmed frame's ldr (H, W, 3) in [0, 1] on the device), "state" (the
    final BodyState), "frame_state", "settle_s", "frame_ms" (host ms of
    each filmed frame, synchronised), "ms_per_frame" (their mean past the
    first: the first builds the kernels), "world" (`flythrough_world`'s),
    "settled" (the state after the settling frames), and "advance" /
    "render" / "camera", the frame's steps: `advance(state) -> (state,
    bvh)`, `render(bvh, camera, prev_camera, frame_state, jitter) -> (ldr,
    frame_state, aux)` and `camera(f)`."""
    import time

    from .core import profiling
    from .core.graphs import Graphed
    from .ops.ray_trace import DeferredError
    from .render import pathtracer as pt
    from .render.instances import retransform
    from .render.pipeline import (RendererSettings, initial_frame_state,
                                  render_frame)
    from .render.shadows import fit_cascades, render_sun_shadow_maps

    device = resolve_device(device)
    world = flythrough_world(device, pile_seed)
    settings = RendererSettings(primary="raster",
                                half_res_effects=half_res_effects)
    resolution = (FLYTHROUGH_SHADOW_RESOLUTION if shadow_resolution is None
                  else shadow_resolution)
    orbit = frames if orbit_frames is None else orbit_frames
    static_pos = torch.zeros((1, 3), device=device)
    static_rot = torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=device)
    generator = torch.Generator(device=device).manual_seed(seed)
    physics = _physics_runner(world.arch, PhysicsSettings())
    error = DeferredError(device)
    cuda = device.type == "cuda"
    cameras = [flythrough_camera(f, orbit, width, height, device)
               for f in range(max(orbit, 1))]

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def pose(pos, rot):
        return retransform(world.instances, torch.cat([pos[0], static_pos]),
                           torch.cat([rot[0], static_rot]), tree=True)

    def camera(f):
        return cameras[f % len(cameras)]

    def cascades(bvh, cam, stats=None):
        maps = fit_cascades(cam.position, -world.sky.sun_direction)
        return render_sun_shadow_maps(bvh, maps, resolution=resolution,
                                      error=error.word, stats=stats)

    def span(name, on):
        return profiling.profile_block(name, device=cuda, force=on)

    def posed_frame(pos, rot, frame_state, cam, prev_camera, jitter,
                    profile_stages=False, timed=None):
        """The frame after the physics: the pile posed into its tree, the
        cascades, the raster frame.  (ldr, frame state, bvh, maps, aux)."""
        timed = timed or (lambda name: contextlib.nullcontext())
        with timed("inst.tree"):
            bvh = pose(pos, rot)
        with timed("shadow.cascades"):
            maps = cascades(bvh, cam)
        with timed("raster.frame"):
            scene = pt.Scene(bvh=bvh, materials=world.materials,
                             sky=world.sky)
            ldr, fstate, aux = render_frame(
                scene, cam, width, height, settings, shadow_maps=maps,
                point_lights=world.lights, frame_state=frame_state,
                prev_camera=prev_camera, jitter=jitter,
                profile_stages=profile_stages)
        return ldr, fstate, bvh, maps, aux

    def graphed_part(*args):
        return posed_frame(*args)[:4]

    graphs = Graphed(graphed_part)

    @torch.inference_mode()
    def fn(game: GameState, jitter=None, profile_stages: bool = False):
        error.poll()
        spans = []

        def timed(name):
            s = span(name, profile_stages)
            if profile_stages:
                spans.append(s)
            return s

        cam = camera(game.frame)
        if jitter is None:
            jitter = torch.rand(2, generator=generator, device=device)
        with timed("game.frame"):
            with timed("phys.frame"):
                bodies, contacts = physics(game.bodies, 1)
            args = (bodies.pos, bodies.rot, game.frame_state, cam,
                    game.prev_camera or cam, jitter)
            if profile_stages:
                ldr, fstate, bvh, maps, aux = posed_frame(
                    *args, profile_stages=True, timed=timed)
            else:
                ldr, fstate, bvh, maps = graphs(*args)
                aux = {}
        error.arm()
        counts = {"phys.pairs": int(contacts.active.shape[-1]),
                  "phys.contact_rows": contacts.active.sum(),
                  "shadow.rays": int(maps.depth.numel())}
        for name, value in counts.items():
            profiling.profile_stat(name, value)
        aux.update(bvh=bvh, shadow_maps=maps, contacts=contacts)
        if profile_stages:
            profiling._resolve(spans)
            stage_ms = aux.get("stage_ms", {})
            aux["stage_ms"] = {**{s.name: (s.host_ms if s.device_ms is None
                                           else s.device_ms) for s in spans},
                               **{f"raster.{k}": v for k, v in stage_ms.items()}}
            counts = {k: (float(v) if isinstance(v, torch.Tensor) else v)
                      for k, v in counts.items()}
            if cuda:
                # The kernel's test counts cost an atomic a ray: taken from a
                # second query of the same rays, outside the spans.
                stats = torch.zeros(2, dtype=torch.int64, device=device)
                cascades(bvh, cam, stats)
                counts["shadow.rows_tested"] = (float(stats[0])
                                                / counts["shadow.rays"])
            aux["counts"] = counts
        return ldr, GameState(bodies, fstate, game.frame + 1, cam), aux

    @torch.inference_mode()
    def advance(bodies):
        bodies, _ = physics(bodies, 1)
        return bodies, pose(bodies.pos, bodies.rot)

    @torch.inference_mode()
    def render(bvh, cam, prev_camera, frame_state, jitter):
        scene = pt.Scene(bvh=bvh, materials=world.materials, sky=world.sky)
        return render_frame(
            scene, cam, width, height, settings,
            shadow_maps=cascades(bvh, cam), point_lights=world.lights,
            frame_state=frame_state, prev_camera=prev_camera, jitter=jitter)

    bodies = world.state if state is None else state
    t0 = time.perf_counter()
    if settle_frames:
        bodies, _ = physics(bodies, settle_frames)
    sync()
    settle_s = time.perf_counter() - t0
    start = GameState(bodies, initial_frame_state(width, height, device))
    game, out, frame_ms = start, [], []
    for f in range(frames):
        t0 = time.perf_counter()
        ldr, game, _ = fn(game, None if jitters is None else jitters[f])
        sync()
        frame_ms.append(1e3 * (time.perf_counter() - t0))
        out.append(ldr)
    error.check()
    steady = frame_ms[1:] or frame_ms
    return {"fn": fn, "game": game, "start": start, "frames": out,
            "state": game.bodies, "frame_state": game.frame_state,
            "settle_s": settle_s, "frame_ms": frame_ms,
            "ms_per_frame": sum(steady) / max(len(steady), 1),
            "world": world, "settled": start.bodies, "advance": advance,
            "render": render, "camera": camera, "physics": physics,
            "graphs": graphs}


# The skinned character of character_entry and character_ragdoll_entry,
# generated here and written to FBX (as tests/test_fbx_skin_anim.py and
# tests/test_ragdoll_from_skeleton.py make theirs): the 19-joint rig of
# tests/test_ragdoll_from_skeleton.py:24-38 with spine_2, neck, the
# clavicles, hands and feet added; (name, parent, local translation, local
# Euler degrees), every joint's local +Y along its bone.
CHARACTER_JOINTS = (
    ("pelvis", -1, (0.0, 0.95, 0.0), (0.0, 0.0, 0.0)),
    ("spine", 0, (0.0, 0.2, 0.0), (0.0, 0.0, 0.0)),
    ("spine_2", 1, (0.0, 0.2, 0.0), (0.0, 0.0, 0.0)),
    ("neck", 2, (0.0, 0.22, 0.0), (0.0, 0.0, 0.0)),
    ("head", 3, (0.0, 0.1, 0.0), (0.0, 0.0, 0.0)),
    # The left arm along -X: Rz(+90) maps +Y to -X.
    ("left_clavicle", 2, (-0.04, 0.17, 0.0), (0.0, 0.0, 90.0)),
    ("left_upper_arm", 5, (0.0, 0.14, 0.0), (0.0, 0.0, 0.0)),
    ("left_lower_arm", 6, (0.0, 0.28, 0.0), (0.0, 0.0, 0.0)),
    ("left_hand", 7, (0.0, 0.26, 0.0), (0.0, 0.0, 0.0)),
    ("right_clavicle", 2, (0.04, 0.17, 0.0), (0.0, 0.0, -90.0)),
    ("right_upper_arm", 9, (0.0, 0.14, 0.0), (0.0, 0.0, 0.0)),
    ("right_lower_arm", 10, (0.0, 0.28, 0.0), (0.0, 0.0, 0.0)),
    ("right_hand", 11, (0.0, 0.26, 0.0), (0.0, 0.0, 0.0)),
    # The legs along -Y (Rz(180)), the feet forward along +Z (Rx(90)).
    ("left_upper_leg", 0, (-0.1, 0.0, 0.0), (0.0, 0.0, 180.0)),
    ("left_lower_leg", 13, (0.0, 0.42, 0.0), (0.0, 0.0, 0.0)),
    ("left_foot", 14, (0.0, 0.42, 0.0), (90.0, 0.0, 0.0)),
    ("right_upper_leg", 0, (0.1, 0.0, 0.0), (0.0, 0.0, 180.0)),
    ("right_lower_leg", 16, (0.0, 0.42, 0.0), (0.0, 0.0, 0.0)),
    ("right_foot", 17, (0.0, 0.42, 0.0), (90.0, 0.0, 0.0)),
)
# Each joint's tube: its length along the bone and its radius.
CHARACTER_TUBES = (
    (0.2, 0.13), (0.2, 0.12), (0.22, 0.13), (0.1, 0.05), (0.22, 0.1),
    (0.14, 0.05), (0.28, 0.05), (0.26, 0.045), (0.12, 0.04),
    (0.14, 0.05), (0.28, 0.05), (0.26, 0.045), (0.12, 0.04),
    (0.42, 0.07), (0.42, 0.055), (0.18, 0.045),
    (0.42, 0.07), (0.42, 0.055), (0.18, 0.045),
)
# (rings, segments) of a tube: 19 x 416 = 7,904 control points and
# 19 x (12 x 32 x 2 + 2 x 32) = 15,808 triangles; coarse for the CPU tests,
# 570 triangles.
CHARACTER_TUBE_GRID = (13, 32)
CHARACTER_COARSE_GRID = (3, 5)
# The clip: one 2 s loop keyed at 30 fps, a rotation track on every joint
# and a translation track on the root.
CHARACTER_CLIP_SECONDS = 2.0
CHARACTER_FPS = 30
# character_entry's frame time and materials: the crowd, character 0 and
# the meta-balls prop, after the atrium's six.
CHARACTER_FRAME_DT = 1.0 / 30.0
CHARACTER_ALBEDO = [[0.25, 0.45, 0.7], [0.85, 0.3, 0.2], [0.4, 0.75, 0.35]]
CHARACTER_ROUGHNESS = [0.5, 0.45, 0.3]
CROWD_MATERIAL, CHARACTER0_MATERIAL, PROP_MATERIAL = 6, 7, 8
# The crowd stands on the ground outside the atrium's south wall, facing
# raster_entry's camera, in rows from CROWD_FRONT back by CROWD_DEPTH, each
# row centred at x = CROWD_CENTRE[0] + CROWD_CENTRE[1] * (its fraction of
# the depth) and CROWD_SPAN[0] - CROWD_SPAN[1] * (the same) wide on either
# side: the ground that a standing character's feet and head are both in
# the 16:9 frame is a trapezoid, z from -9 (x in [-10, 2]) to -11.5
# (x in [-3, -2]).  Character 0 takes the slot nearest CROWD_HERO.
CROWD_FRONT, CROWD_DEPTH = -9.1, 1.5
CROWD_CENTRE = (-3.0, -0.5)
CROWD_SPAN = (3.5, 1.8)
CROWD_HERO = (-3.2, -9.8)
PROP_CENTERS = ((0.0, 0.0, 0.0), (0.45, 0.25, 0.1), (-0.35, 0.3, -0.2))
PROP_RADII = (0.5, 0.38, 0.33)
PROP_AT = (-8.3, 0.7, -9.5)
BONE_COLOR = (0.1, 1.0, 0.3)


def _character_mesh(grid):
    """Control points (V, 3), triangles (T, 3) and per-joint clusters of the
    tube mesh in its bind pose.  A vertex at fraction s of its joint's
    tube blends towards the parent below s = 0.3 and the first child above
    0.7 (up to half each), and keeps 0.02 on the grandparent: at most 4
    influences."""
    from .assets.fbx import _euler_deg_to_quat
    from .models.ragdoll import _bind_world, _quat_to_mat

    rings, segs = grid
    parents = [j[1] for j in CHARACTER_JOINTS]
    bp = np.array([j[2] for j in CHARACTER_JOINTS], np.float64)
    br = np.stack([_euler_deg_to_quat(j[3]) for j in CHARACTER_JOINTS])
    wp, wr = _bind_world(parents, bp, br)
    children = {}
    for i, p in enumerate(parents):
        if p >= 0:
            children.setdefault(p, i)
    points, tris = [], []
    weights = [dict() for _ in CHARACTER_JOINTS]     # joint -> {cp: w}
    ang = 2.0 * math.pi * np.arange(segs) / segs
    for j, (length, radius) in enumerate(CHARACTER_TUBES):
        rot = _quat_to_mat(wr[j])
        p = parents[j] if parents[j] >= 0 else j
        c = children.get(j, j)
        gp = parents[p] if parents[p] >= 0 else p
        base = len(points)
        for r, s in enumerate(np.linspace(0.0, 1.0, rings)):
            for a in ang:
                local = np.array([radius * math.cos(a), s * length,
                                  radius * math.sin(a)])
                points.append(wp[j] + rot @ local)
                up = 0.5 * max(0.0, 0.3 - s) / 0.3 if p != j else 0.0
                down = 0.5 * max(0.0, s - 0.7) / 0.3 if c != j else 0.0
                cp = len(points) - 1
                for joint, w in ((j, 1.0 - up - down - 0.02), (p, up),
                                 (c, down), (gp, 0.02)):
                    if w > 0.0:
                        weights[joint][cp] = weights[joint].get(cp, 0.0) + w
        for r in range(rings - 1):
            for k in range(segs):
                a0 = base + r * segs + k
                a1 = base + r * segs + (k + 1) % segs
                b0, b1 = a0 + segs, a1 + segs
                tris += [(a0, b0, a1), (a1, b0, b1)]
        for end, s in ((0, 0.0), (rings - 1, 1.0)):
            centre = len(points)
            points.append(wp[j] + rot @ np.array([0.0, s * length, 0.0]))
            weights[j][centre] = 1.0
            ring0 = base + end * segs
            for k in range(segs):
                a0, a1 = ring0 + k, ring0 + (k + 1) % segs
                tris.append((centre, a1, a0) if end == 0 else
                            (centre, a0, a1))
    clusters = [(j, sorted(w), [w[i] for i in sorted(w)])
                for j, w in enumerate(weights) if w]
    return np.asarray(points), np.asarray(tris, np.int32), clusters


def _character_tracks():
    """The walk-like clip: (rotation tracks {joint: (times, Euler degrees
    (K, 3))}, translation tracks {0: (times, (K, 3))}).  Each track is the
    bind Euler plus a swing of period CHARACTER_CLIP_SECONDS, so key 0 and
    the last key agree and the clip loops."""
    k = int(round(CHARACTER_CLIP_SECONDS * CHARACTER_FPS)) + 1
    times = np.arange(k) / CHARACTER_FPS
    ph = 2.0 * math.pi * times / CHARACTER_CLIP_SECONDS
    swing = {   # joint: (axis, degrees, phase)
        "left_upper_leg": (0, 28.0, 0.0), "right_upper_leg": (0, 28.0, math.pi),
        "left_lower_leg": (0, -22.0, 0.5), "right_lower_leg": (0, -22.0, 0.5 + math.pi),
        "left_upper_arm": (2, 18.0, math.pi), "right_upper_arm": (2, 18.0, 0.0),
        "left_lower_arm": (1, 15.0, math.pi), "right_lower_arm": (1, 15.0, 0.0),
        "pelvis": (1, 6.0, 0.0), "spine_2": (1, -8.0, 0.0),
    }
    rot = {}
    for j, (name, _, _, euler) in enumerate(CHARACTER_JOINTS):
        axis, deg, phase = swing.get(name, (j % 3, 3.0, 0.3 * j))
        e = np.tile(np.asarray(euler, np.float64), (k, 1))
        e[:, axis] += deg * np.sin(ph + phase)
        rot[j] = (times, e)
    root = np.tile(np.asarray(CHARACTER_JOINTS[0][2], np.float64), (k, 1))
    root[:, 1] += 0.03 * np.sin(2.0 * ph)
    return rot, {0: (times, root)}


def write_character(path: str, coarse: bool = False):
    """Write the generated character (mesh, skin, skeleton, clip) to a
    binary FBX at `path` with the port's writer."""
    from .assets.fbx import write_fbx_skinned

    points, tris, clusters = _character_mesh(
        CHARACTER_COARSE_GRID if coarse else CHARACTER_TUBE_GRID)
    rot, pos = _character_tracks()
    write_fbx_skinned(path, points, tris, CHARACTER_JOINTS, clusters, rot,
                      fps=CHARACTER_FPS, anim_pos_tracks=pos)


def load_character(coarse: bool = False):
    """The character written to a temporary directory, read back through
    the asynchronous loader and `load_fbx`: a `ModelAsset`."""
    import tempfile

    from .assets.async_loader import AsyncLoader
    from .assets.fbx import load_fbx

    loader = AsyncLoader(workers=1)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = f"{tmp}/character.fbx"
            write_character(path, coarse)
            return loader.submit(path, load_fbx).wait(timeout=600)
    finally:
        loader.shutdown()


def placed_clip(clip, x: float, z: float, yaw: float):
    """The loaded clip (host arrays) with its root turned by `yaw` radians
    about +Y and moved to (x, z): one crowd member's clip."""
    from .assets.loaders import LoadedClip
    from .physics.builder import _quat_mul_np

    q = np.array([0.0, math.sin(yaw / 2), 0.0, math.cos(yaw / 2)])
    c, s = math.cos(yaw), math.sin(yaw)
    pos = clip.positions.astype(np.float64).copy()
    rots = clip.rotations.astype(np.float64).copy()
    p0 = pos[0].copy()
    pos[0, :, 0] = c * p0[:, 0] + s * p0[:, 2] + x
    pos[0, :, 2] = -s * p0[:, 0] + c * p0[:, 2] + z
    rots[0] = np.stack([_quat_mul_np(q, r) for r in rots[0]])
    return LoadedClip(name=clip.name, positions=pos.astype(np.float32),
                      rotations=rots.astype(np.float32), scales=clip.scales,
                      duration=clip.duration, looping=clip.looping)


def crowd_slots(crowd: int):
    """(x, z) of each crowd member: CROWD_* rows, character 0 nearest
    CROWD_HERO."""
    cols = math.ceil(math.sqrt(crowd))
    rows = math.ceil(crowd / cols)
    slots = []
    for i in range(crowd):
        f = (i // cols) / max(rows - 1, 1)
        fx = (i % cols + 0.5) / cols
        slots.append((CROWD_CENTRE[0] + CROWD_CENTRE[1] * f
                      + (CROWD_SPAN[0] - CROWD_SPAN[1] * f) * (2 * fx - 1),
                      CROWD_FRONT - CROWD_DEPTH * f))
    hero = min(range(crowd), key=lambda i: math.hypot(
        slots[i][0] - CROWD_HERO[0], slots[i][1] - CROWD_HERO[1]))
    return [slots[hero]] + slots[:hero] + slots[hero + 1:]


class CharacterState:
    """character_entry's carried state: the frame's temporal resources,
    the raster primary's occlusion feedback and the clip time."""

    def __init__(self, frame, tile_qmin, time: float):
        self.frame, self.tile_qmin, self.time = frame, tile_qmin, time


def character_entry(device="cuda", width: int = 1920, height: int = 1080,
                    crowd: int = 16, seed: int = 0, coarse: bool = False):
    """Skinned characters in the raster frame (the reference's animated
    render split, renderAnimatedObjects, scene_rendering.cpp:548): the
    atrium of `_atrium` as a rigid `InstancedScene` at identity poses, a
    `metaballs_mesh` prop (resolution 32, generated on the CPU) as a second
    rigid instance, and
    `crowd` instances of the generated character (`load_character`: FBX
    through the asynchronous loader) standing outside the atrium's south
    wall facing the camera, each with its own clip phase and placement
    (`placed_clip`), character 0 in its own material.  The sun's 3
    cascades at `RASTER_SHADOW_RESOLUTION`^2 are rendered once from the
    static atrium through kernel #3: the characters receive the sun's
    shadow but cast none.  Phases and yaws come from a CPU generator
    seeded `seed`; the frames' jitter from one on `device`.

    Returns `(fn, state)`: `fn(state, profile_stages=False, jitter=None,
    **overrides) -> (image, state, aux)` renders the frame at the state's
    clip time and advances it by CHARACTER_FRAME_DT: `build_frame_bvh`
    (the rigid rows, then every character's skinned rows), `render_frame`
    with `RendererSettings(primary="raster", half_res_effects=True)` (no RT
    reflections and no glass: a per-frame one-leaf shell over every row
    would make each traced ray test them all) through the raster's group
    path with last frame's `tile_qmin` fed back, then, on the tonemapped
    frame, `draw_outlines` of character 0's material and `rasterize_lines`
    of its bones.  `overrides` replace `render_frame`'s options for one
    frame.  aux is `render_frame`'s plus "frame_ldr" (before the
    overlays), "bvh" and "visits" (the raster's phase-1 and phase-2 visits
    and dirty tiles).  `fn.skinned`, `fn.rigid`, `fn.rigid_pose`,
    `fn.camera`, `fn.phases` (CPU), `fn.materials` and `fn.sky` hold the
    set-up."""
    from .animation.animation import forward_kinematics, sample_clip
    from .render import mesh as mesh_mod
    from .render import pathtracer as pt
    from .render.debug_viz import draw_outlines, rasterize_lines
    from .render.geometry_gen import metaballs_mesh
    from .render.instances import build_instanced
    from .render.pipeline import (RendererSettings, initial_frame_state,
                                  render_frame)
    from .render.skinned_instances import (build_frame_bvh, from_model_asset,
                                           with_clip)

    device = resolve_device(device)
    meshes = mesh_mod.atrium_scene(1.4)
    static, camera = _atrium(device, width, height, meshes)
    maps = _sun_maps(static, camera, RASTER_SHADOW_RESOLUTION)
    # The prop's mesh is host data: generated on the CPU, so that every
    # device renders the same surface (a field rounded otherwise can flip
    # a cell's crossing).
    prop = metaballs_mesh(PROP_CENTERS, PROP_RADII, resolution=32,
                          device="cpu")
    rigid = build_instanced(list(meshes) + [(prop, PROP_MATERIAL)],
                            range(len(meshes) + 1), device=device)
    n_inst = len(meshes) + 1
    rigid_pos = torch.zeros((n_inst, 3), device=device)
    rigid_pos[-1] = torch.tensor(PROP_AT, device=device)
    rigid_rot = torch.zeros((n_inst, 4), device=device)
    rigid_rot[:, 3] = 1.0

    asset = load_character(coarse)
    base = from_model_asset(asset, material=CROWD_MATERIAL, device=device)
    gen = torch.Generator().manual_seed(seed)
    clip = asset.animations[0]
    phases = torch.rand(crowd, generator=gen) * clip.duration
    yaws = math.pi + (torch.rand(crowd, generator=gen) - 0.5) * 0.8
    skinned = []
    for i, (x, z) in enumerate(crowd_slots(crowd)):
        placed = placed_clip(clip, x, z, float(yaws[i]))
        skinned.append(with_clip(
            base, placed.to_clip(device),
            CHARACTER0_MATERIAL if i == 0 else CROWD_MATERIAL))
    atrium_mats = static.materials

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    materials = pt.Materials(
        albedo=torch.cat([atrium_mats.albedo, f32(CHARACTER_ALBEDO)]),
        emissive=torch.cat([atrium_mats.emissive,
                            torch.zeros((3, 3), device=device)]),
        roughness=torch.cat([atrium_mats.roughness, f32(CHARACTER_ROUGHNESS)]),
        metallic=torch.cat([atrium_mats.metallic,
                            torch.zeros(3, device=device)]))
    phases_dev = phases.to(device)
    parents = [j[1] for j in CHARACTER_JOINTS]
    bone_child = torch.tensor([j for j, p in enumerate(parents) if p >= 0],
                              device=device)
    bone_parent = torch.tensor([p for p in parents if p >= 0], device=device)
    settings = RendererSettings(primary="raster", half_res_effects=True)
    generator = torch.Generator(device=device).manual_seed(seed)
    sky = static.sky

    @torch.inference_mode()
    def fn(state, profile_stages: bool = False, jitter=None, **overrides):
        if jitter is None:
            jitter = torch.rand(2, generator=generator, device=device)
        times = phases_dev + state.time
        bvh = build_frame_bvh(rigid, rigid_pos, rigid_rot, skinned, times)
        scene = pt.Scene(bvh=bvh, materials=materials,
                         sky=sky).with_shading_table()
        kw = {"shadow_maps": maps, "settings": settings, **overrides}
        ldr, frame, aux = render_frame(
            scene, camera, width, height, kw.pop("settings"),
            frame_state=state.frame, prev_camera=camera, jitter=jitter,
            profile_stages=profile_stages, binning="group",
            tile_qmin=state.tile_qmin, **kw)
        out = draw_outlines(ldr, aux["gbuffer"].object_id,
                            CHARACTER0_MATERIAL)
        first = skinned[0]
        joints, _ = forward_kinematics(first.skeleton,
                                       sample_clip(first.clip, times[0]))
        out = rasterize_lines(out, torch.stack(
            [joints[bone_parent], joints[bone_child]], 1), BONE_COLOR,
            camera)
        aux.update(frame_ldr=ldr, bvh=bvh, visits=aux["gbuffer"].visits)
        return out, CharacterState(frame, aux["tile_qmin"],
                                   state.time + CHARACTER_FRAME_DT), aux

    fn.skinned, fn.rigid, fn.camera = skinned, rigid, camera
    fn.phases, fn.materials, fn.sky = phases, materials, sky
    fn.rigid_pose = (rigid_pos, rigid_rot)
    return fn, CharacterState(initial_frame_state(width, height, device),
                              None, 0.0)


# character_ragdoll_entry: the drop's heights above the plane (lowest
# capsule point) and spins (rad/s about each axis), per scene.
RAGDOLL_DROP = (0.3, 2.0)
RAGDOLL_SPIN = 2.0
RAGDOLL_FRAME_RATE = 60


def fitted_lowest(fitted, local_cog, pos, rot) -> float:
    """The lowest point of a fitted ragdoll's capsules for one scene's
    body centres of mass `pos` (N, 3) and rotations `rot` (N, 4) (CPU
    tensors; `local_cog` the archetype's): each capsule's ends, less its
    radius."""
    from .core import maths as m

    low = math.inf
    for limb, body in fitted.bodies.items():
        f = fitted.fits[limb]
        origin = pos[body] - m.quat_rotate(rot[body], local_cog[body])
        for y in (f.min_y, f.max_y):
            end = origin + m.quat_rotate(rot[body], torch.tensor(
                [f.x_off, y, f.z_off], dtype=torch.float32))
            low = min(low, float(end[1]) - f.radius)
    return low


def character_ragdoll_entry(device="cuda", batch: int = 4096, seed: int = 0,
                            coarse: bool = False):
    """A physics ragdoll fitted from the generated character's skeleton and
    skin (`models.ragdoll.from_fbx_asset`: 14 capsules, 4 hinges and 9
    cone-twists in one no-collide group; reference animation.h:100-152)
    over a static plane, `batch` copies, each lifted to its own drop
    height in RAGDOLL_DROP and spun as one rigid body at up to
    RAGDOLL_SPIN rad/s about each axis (a CPU generator seeded `seed`),
    stepped with `physics_step` at RAGDOLL_FRAME_RATE Hz: one substep a
    frame, the fused whole-substep kernel where the archetype is in its
    family (kernel #2), else the unfused step with the colored solver.

    Returns `(fn, (arch, state, fitted))`: `fn(state, steps=1) -> (state,
    contacts)` advances every scene by `steps` frames of
    1 / RAGDOLL_FRAME_RATE s."""
    from .models.ragdoll import from_fbx_asset
    from .physics.builder import SceneBuilder
    from .physics.step import physics_step

    device = resolve_device(device)
    asset = load_character(coarse)
    b = SceneBuilder()
    b.add_static_plane((0.0, 1.0, 0.0), 0.0, friction=1.0)
    fitted = from_fbx_asset(b, asset)
    arch, state = b.finalize(device=device)
    state = _batched(state, batch)
    gen = torch.Generator().manual_seed(seed)
    lift = RAGDOLL_DROP[0] + torch.rand(batch, generator=gen) * (
        RAGDOLL_DROP[1] - RAGDOLL_DROP[0])
    spin = (torch.rand((batch, 3), generator=gen) * 2 - 1) * RAGDOLL_SPIN
    pos = state.pos.cpu()
    lowest = fitted_lowest(fitted, arch.local_cog.cpu(), pos[0],
                           state.rot[0].cpu())
    pos[:, :, 1] += (lift - lowest)[:, None]
    com = pos.mean(1, keepdim=True)
    vel = torch.cross(spin[:, None, :].expand_as(pos), pos - com, dim=-1)
    state = state.replace(pos=pos.to(device),
                          vel=vel.to(device=device, dtype=torch.float32),
                          omega=spin[:, None, :].expand_as(pos).to(
                              device=device, dtype=torch.float32)
                          .contiguous())
    settings = PhysicsSettings(frame_rate=RAGDOLL_FRAME_RATE)

    @torch.inference_mode()
    def fn(state, steps: int = 1):
        contacts = None
        for _ in range(steps):
            state, contacts = physics_step(arch, state, settings,
                                           1.0 / RAGDOLL_FRAME_RATE)
        return state, contacts

    return fn, (arch, state, fitted)


def _kernel_wrappers():
    """The launch-counting wrappers of the kernels the editor path may run:
    #1 (colored solve), #2 (fused substep), #3 (BVH walk), #4 (brute
    force), #8 (the path tracer's shading, two kernels)."""
    from .ops import pt_shade, ray_trace
    from .physics import solver_cuda, substep_cuda

    return {"colored": solver_cuda.colored_solve_cuda,
            "fused": substep_cuda.fused_substep_cuda,
            "bvh": ray_trace.ray_closest_hit_bvh,
            "brute": ray_trace.ray_closest_hit_brute,
            "shade_hit": pt_shade.shade_hit,
            "shade_next": pt_shade.shade_next}


def editor_entry(device="cuda", size: int = 256, views: int = 4,
                 spp: int = 6, play_frames: int = 120):
    """The editor path at tools/scene_viewer.py's defaults
    (`scene.viewer`): the demo scene built through the ECS layer, written
    to YAML and read back (the read-back scene is the editor's), the static
    page (`views` orbit views path-traced at `size` with `spp` samples and
    recursion depth 2, the first view's normals, depth, object id and AO
    panels, the physics line, the entity table), then the live viewer on
    127.0.0.1 at a free port in a thread, driven through every endpoint by
    `viewer.editor_session`: two orbits, the aux kinds, a transform edit
    with undo and redo, play for `play_frames` frames of 1/60 s (one
    `physics_step` on the device and one beauty render at
    `viewer.PLAY_SPP` samples each), pause, stop, a material edit, and a motor retarget
    during play.  Scenes of more than 1,024 rows path-trace through the
    BVH kernel; play mode's rows go through the colored-solver kernel, or
    the fused substep where the archetype is in its family.

    Returns a dict: "yaml" (the document written and the one read back),
    "static" (`viewer.write_static`'s parts, "html" the page), "static_s",
    "session" (`editor_session`'s observations), "ms" (host ms per request,
    by path), "launches" (per kernel, over the whole entry), "session_s"."""
    import os
    import tempfile
    import threading
    import time

    from .scene import viewer
    from .scene.scene import Scene

    device = resolve_device(device)
    wrappers = _kernel_wrappers()
    before = {k: w.launches for k, w in wrappers.items()}
    authored = viewer.build_demo_scene()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "demo.yaml")
        authored.save_yaml(path)
        scene = Scene.load_yaml(path)
        t0 = time.perf_counter()
        static = viewer.write_static(scene, os.path.join(tmp, "demo.html"),
                                     "demo", size, views, spp, device)
        static_s = time.perf_counter() - t0
        with open(os.path.join(tmp, "demo.html")) as f:
            static["html"] = f.read()

    editor = viewer.Editor(scene, size, spp, device)
    httpd = viewer.make_server(editor, 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    client = viewer.Client(f"http://127.0.0.1:{httpd.server_address[1]}")
    try:
        t0 = time.perf_counter()
        session = viewer.editor_session(client, editor, size, spp,
                                        play_frames)
        session_s = time.perf_counter() - t0
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join()
    return {"yaml": (authored.to_document(), scene.to_document()),
            "static": static, "static_s": static_s, "session": session,
            "session_s": session_s, "ms": client.ms,
            "launches": {k: w.launches - before[k]
                         for k, w in wrappers.items()}}
