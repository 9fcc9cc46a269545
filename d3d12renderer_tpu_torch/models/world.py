"""examples/showcase.py's world, built by the port (`build_world`): the
terrain's LOD chunks with the splat texture, the physics drop settled on
the terrain (its impacts mixed to a WAV by `write_impact_audio`, as the
script's `--audio` does), placed trees, culled grass, the physics-settled meshes, the
HDR sky through the image cache and `render.ibl`, one shadow atlas for the
sun, a spot and a point light, probes, a decal, a glass slab and fire
particles; then the frame's options (`WorldFrame.options`) and the
particles' additive splat.

`WorldConfig()` is the script's world (showcase.py:93-378); the tests cut
it (`dataclasses.replace`).  The set-up's random draws come from a CPU
generator seeded `seed` (a stream depends on its device): the tree layer's
(`terrain.placement` order), the grass' (`terrain.grass` order), then the
probe updates' rotations; the fire pool draws from its own generator on the
device, seeded `seed`.  `draws` replaces any of them: {"trees": layers'
draws, "grass": blades' draws, "probes": [rotation, ...], "fire": [per
step emission draws, ...]}, as the tests inject the JAX package's.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from . import scenes

# showcase.py:87-92: the 48 m heightmap of 65 x 65 samples
# (`scenes.TERRAIN_DROP_MAP`).
WORLD_SIZE = scenes.TERRAIN_DROP_MAP["world_size"]
WORLD_ORIGIN = scenes.TERRAIN_DROP_ORIGIN
CAMERA_EYE = (0.0, 7.5, -16.0)
CAMERA_TARGET = (0.0, 1.5, 0.0)
CAMERA_FOV_DEG = 50.0
SPLAT_ALBEDOS = ((0.20, 0.42, 0.12), (0.38, 0.35, 0.33), (0.88, 0.88, 0.92))
TREE_LAYER = dict(max_height=3.4, max_slope_y=0.65, density=0.055,
                  scale_range=(0.85, 1.2))
# Materials 0-6: terrain (tinted by the splat texture), unused, trunk,
# canopy, grass, boxes, spheres (metal).
ALBEDO = ((1.0, 1.0, 1.0), (0.5, 0.5, 0.5), (0.45, 0.3, 0.18),
          (0.15, 0.4, 0.12), (0.25, 0.5, 0.15), (0.7, 0.25, 0.2),
          (0.9, 0.9, 0.95))
ROUGHNESS = (0.9, 0.5, 0.8, 0.7, 0.6, 0.5, 0.15)
METALLIC = (0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0)
MAT_TERRAIN, MAT_TRUNK, MAT_CANOPY, MAT_GRASS, MAT_BOX, MAT_SPHERE = (
    0, 2, 3, 4, 5, 6)
ENVMAP = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "examples", "data", "studio.hdr")
SPOT = dict(position=(5.0, 9.0, -4.0), direction=(-0.4, -0.85, 0.35),
            color=(45.0, 42.0, 38.0), distance=28.0, inner_cos=0.85,
            outer_cos=0.65)
POINT_COLOR, POINT_RADIUS = (30.0, 22.0, 12.0), 16.0
PROBES = dict(origin=(-12.0, 0.5, -12.0), extent=(24.0, 8.0, 24.0),
              dims=(5, 3, 5))
DECAL = dict(rotations=[(0.7071, 0.0, 0.0, 0.7071)],
             half_extents=[(1.2, 1.2, 2.0)], albedos=[(0.05, 0.05, 0.06)])
GLASS_HALF, GLASS_XZ = (1.2, 1.0, 0.08), (3.0, 3.0)
GLASS_COLOR, GLASS_ALPHA = (0.5, 0.8, 0.7), 0.35
# showcase.py:140: begin events closing faster than this (m/s) are impacts.
IMPACT_SPEED = 0.8
FIRE_XZ = (-2.0, -2.0)
FIRE_DT = 1.0 / 60.0
PARTICLE_COLOR = (1.0, 0.45, 0.1)
WATER_HEIGHT = 0.9


@dataclass(frozen=True)
class WorldConfig:
    """The script's sizes and counts (showcase.py's defaults)."""

    resolution: int = 65
    chunk_cells: int = 16
    physics_frames: int = 180
    tree_points_per_side: int = 12
    tree_max_instances: int = 8
    grass_per_side: int = 28
    grass_density: float = 0.6
    grass_time: float = 0.4
    grass_lod_distance: float = 18.0
    envmap_face: int = 128
    atlas_size: int = 4096
    sun_resolution: int = 384
    spot_resolution: int = 256
    point_resolution: int = 192
    probe_updates: int = 2
    probe_rays: int = 32
    fire_capacity: int = 256
    fire_steps: int = 45


@dataclass
class World:
    """What `build_world` made: the render scene, camera and frame options,
    the atlas, the fire pool, the physics (archetype, settled state, its
    kinds) and counts for checks."""

    scene: object
    camera: object
    options: dict
    atlas: object
    fire: object
    arch: object
    bodies: object
    body_kinds: list
    heights: torch.Tensor
    counts: dict = field(default_factory=dict)
    # (time, point, speed) of the drop's impacts, with `collect_events`.
    impacts: list = field(default_factory=list)


def _settle(heights, cell: float, frames: int, device,
            collect_events: bool = False):
    """showcase.py:110-147: the six bodies dropped onto the terrain and
    stepped `frames` frames of 1/60 s in 2 substeps at batch 1 (colored
    contacts: one launch of kernel #1 a substep on CUDA tensors).  With
    `collect_events` (showcase.py's `--audio` path) each frame also folds
    its collision events and keeps the begins closing faster than
    IMPACT_SPEED as (time, first contact point, speed), in row order."""
    from ..physics.builder import SceneBuilder
    from ..physics.step import physics_step
    from ..physics.types import PhysicsSettings

    b = SceneBuilder()
    scenes.add_terrain_drop(b, heights, cell_size=cell)
    kinds = ["box" if i % 2 == 0 else "sphere"
             for i in range(scenes.TERRAIN_DROP_BODIES)]
    arch, state = b.finalize(device=device)
    settings = PhysicsSettings()
    impacts = []
    prev_active = None
    with torch.inference_mode():
        for f in range(frames):
            if not collect_events:
                state, _ = physics_step(arch, state, settings, 1.0 / 60.0,
                                        num_substeps=2)
                continue
            state, contacts, ev = physics_step(
                arch, state, settings, 1.0 / 60.0, num_substeps=2,
                collect_events=True, prev_active=prev_active)
            prev_active = ev.active
            begin = ev.begin[0].cpu()
            if begin.any():
                speeds = ev.approach_speed[0].cpu()[begin]
                points = contacts.point[0, :, 0].cpu()[begin]
                impacts += [(f / 60.0, tuple(map(float, p)), float(v))
                            for p, v in zip(points, speeds)
                            if v > IMPACT_SPEED]
    return arch, state, kinds, impacts


def impact_engine(impacts):
    """showcase.py:151-165: an `AudioEngine` listening from the camera with
    the "mountains" reverb, each impact a 3D `impact_synth` voice (seeded
    by its index, louder with its speed) at its time.  A synth voice draws
    its noise from its own generator as it renders, so an engine renders
    once: build another to render the timeline again."""
    from ..audio.audio import AudioEngine, impact_synth

    eng = AudioEngine()
    eng.set_listener(CAMERA_EYE, forward=(0, -0.25, 1))
    eng.set_reverb("mountains")
    t_prev = 0.0
    for i, (t, p, s) in enumerate(impacts):
        eng.advance(t - t_prev)
        t_prev = t
        eng.play_synth(impact_synth(s, seed=i), "sfx",
                       volume=min(1.0, 0.25 + s / 10.0), position=p)
    return eng


def impact_seconds(frames: int) -> float:
    """The mix's length: the drop's `frames` / 60 s and half a second."""
    return frames / 60.0 + 0.5


def write_impact_audio(impacts, path: str, frames: int) -> float:
    """showcase.py:166-169: `impact_engine`'s mixdown over
    `impact_seconds(frames)` written to a WAV at `path`; returns its
    seconds."""
    from ..audio.mixdown import mixdown, write_wav

    seconds = impact_seconds(frames)
    write_wav(path, mixdown(impact_engine(impacts), seconds))
    return seconds


def load_sky(device, face_res: int, envmap: Optional[str] = ENVMAP):
    """showcase.py:253-272: the default sky with the equirect `envmap`
    (decoded through the float image cache) as a `face_res` cubemap and
    `assets.envmap.DEFAULT_SUN` as its sun; `envmap=None` the procedural
    sky.  Returns (sky, equirect peak radiance or None)."""
    from dataclasses import replace

    from ..assets.cache import load_image_cached
    from ..assets.envmap import DEFAULT_SUN
    from ..render.ibl import equirect_to_cubemap
    from ..render.pathtracer import default_sky

    sky = default_sky(device=device)
    if envmap is None:
        return sky, None
    mips, _ = load_image_cached(envmap)
    env = torch.from_numpy(np.array(mips[0])).to(device)
    sun = np.asarray(DEFAULT_SUN) / np.linalg.norm(DEFAULT_SUN)
    sky = replace(sky, cubemap=equirect_to_cubemap(env, face_res),
                  sun_direction=torch.as_tensor(sun, dtype=torch.float32,
                                                device=device))
    return sky, float(mips[0].max())


def build_world(device, width: int, height: int, seed: int = 0,
                config: WorldConfig = WorldConfig(), heights=None,
                envmap: Optional[str] = ENVMAP, draws=None,
                collect_events: bool = False) -> World:
    """examples/showcase.py's world on `device`, seen by its camera at
    width / height aspect.  `heights` replaces the generated (R, R)
    heightmap; `envmap=None` gives the procedural sky; `collect_events`
    keeps the drop's impacts (`World.impacts`)."""
    from ..render import bvh as bvh_mod
    from ..render import mesh as mesh_mod
    from ..render.camera import look_at
    from ..render.decals import make_decals
    from ..render.light_probe import create_probe_grid, update_probes
    from ..render.lights import make_point_lights, make_spot_lights
    from ..render.pathtracer import Materials, Scene
    from ..render.pipeline import RendererSettings
    from ..render.shadows import ShadowAtlas
    from ..render.transparent import TransparentObject
    from ..particles import systems
    from ..terrain.grass import generate_grass_blades, grass_lod_triangles
    from ..terrain.heightmap import (generate_heightmap,
                                     sample_height_bilinear, shade_splat,
                                     splat_weights, terrain_lod_chunks)
    from ..terrain.placement import (generate_placement_layers,
                                     instantiate_placement)

    draws = draws or {}
    cfg = config
    cell = WORLD_SIZE / (cfg.resolution - 1)
    cpu = torch.Generator().manual_seed(seed)

    # Terrain (showcase.py:93-108).
    if heights is None:
        heights = generate_heightmap(**{**scenes.TERRAIN_DROP_MAP,
                                        "resolution": cfg.resolution})
    heights = torch.from_numpy(np.array(heights, np.float32))
    chunks = terrain_lod_chunks(heights.numpy(), WORLD_ORIGIN, cell,
                                chunk_cells=cfg.chunk_cells,
                                camera_pos=CAMERA_EYE)
    splat = shade_splat(splat_weights(heights, cell), SPLAT_ALBEDOS)

    def ground(x, z) -> float:
        h, _ = sample_height_bilinear(
            heights, WORLD_ORIGIN, cell, torch.tensor(x, dtype=torch.float32),
            torch.tensor(z, dtype=torch.float32))
        return float(h)

    # Physics (showcase.py:110-147).
    arch, bodies, kinds, impacts = _settle(
        heights.numpy(), cell, cfg.physics_frames, device, collect_events)
    meshes = [(mesh, MAT_TERRAIN) for mesh, _, _ in chunks]

    # Trees (showcase.py:182-194).
    layer = generate_placement_layers(
        heights, WORLD_ORIGIN, cell, WORLD_SIZE, [TREE_LAYER], cpu,
        points_per_side=cfg.tree_points_per_side,
        draws=draws.get("trees"))[0]
    trunk = mesh_mod.cylinder(0.18, 1.2, slices=8).transformed(
        translate=(0.0, 1.2, 0.0))
    canopy = mesh_mod.ico_sphere(1.0, 1).transformed(
        translate=(0.0, 2.8, 0.0))
    trees = (instantiate_placement(layer, [trunk], [MAT_TRUNK],
                                   cfg.tree_max_instances)
             + instantiate_placement(layer, [canopy], [MAT_CANOPY],
                                     cfg.tree_max_instances))
    meshes += trees

    # Grass, culled against the frame's own camera (showcase.py:201-214).
    camera = look_at(CAMERA_EYE, CAMERA_TARGET, device=device,
                     v_fov=math.radians(CAMERA_FOV_DEG), aspect=width / height)
    blades = generate_grass_blades(
        heights, WORLD_ORIGIN, cell, WORLD_SIZE, cpu,
        blades_per_side=cfg.grass_per_side, density=cfg.grass_density,
        draws=draws.get("grass"))
    gverts, gtris, gstats = grass_lod_triangles(
        blades, camera, WORLD_ORIGIN, WORLD_SIZE, time=cfg.grass_time,
        lod_distance=cfg.grass_lod_distance)
    nv = gverts.shape[0]
    meshes.append((mesh_mod.MeshData(
        positions=gverts.numpy().astype(np.float32),
        normals=np.tile(np.array([[0, 1, 0]], np.float32), (nv, 1)),
        uvs=np.zeros((nv, 2), np.float32),
        indices=gtris.numpy().astype(np.int32)), MAT_GRASS))

    # The physics-settled bodies (showcase.py:216-226).
    pos = bodies.pos[0].cpu().numpy()
    rot = bodies.rot[0].cpu().numpy()
    half = scenes.TERRAIN_DROP_HALF
    for kind, p, q in zip(kinds, pos, rot):
        if kind == "box":
            meshes.append((mesh_mod.box((half,) * 3).transformed(
                translate=tuple(p), rotate=tuple(q)), MAT_BOX))
        else:
            meshes.append((mesh_mod.ico_sphere(half, 2).transformed(
                translate=tuple(p)), MAT_SPHERE))
    bvh = bvh_mod.build_bvh(meshes, device=device)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    materials = Materials(
        albedo=f32(ALBEDO), emissive=torch.zeros((7, 3), device=device),
        roughness=f32(ROUGHNESS), metallic=f32(METALLIC),
        texture_atlas=splat.to(device)[None].contiguous(),
        albedo_texture=torch.tensor([0, -1, -1, -1, -1, -1, -1],
                                    dtype=torch.int32, device=device))
    sky, env_peak = load_sky(device, cfg.envmap_face, envmap)
    scene = Scene(bvh=bvh, materials=materials, sky=sky).with_shading_table()

    # Shadows, probes, decal and glass (showcase.py:274-318).
    ppos = (-4.0, ground(-4.0, 2.0) + 2.5, 2.0)
    with torch.inference_mode():
        atlas = ShadowAtlas(cfg.atlas_size, device=device)
        sun_maps = atlas.update_sun(bvh, camera.position, -sky.sun_direction,
                                    resolution=cfg.sun_resolution)
        spot_map = atlas.update_spot(
            bvh, 0, SPOT["position"], SPOT["direction"], SPOT["outer_cos"],
            SPOT["distance"], resolution=cfg.spot_resolution)
        point_map = atlas.update_point(bvh, 0, ppos, POINT_RADIUS,
                                       resolution=cfg.point_resolution)
        grid = create_probe_grid(**PROBES, device=device)
        turns = draws.get("probes")
        if turns is None:
            turns = torch.rand(cfg.probe_updates, generator=cpu)
        for turn in turns:
            grid = update_probes(grid, scene, rotation=turn,
                                 rays_per_probe=cfg.probe_rays)
    gx, gz = GLASS_XZ
    glass = TransparentObject(
        bvh=bvh_mod.build_bvh([(mesh_mod.box(GLASS_HALF).transformed(
            translate=(gx, ground(gx, gz) + 1.2, gz)), 0)], device=device),
        color=GLASS_COLOR, alpha=GLASS_ALPHA)

    # Fire particles (showcase.py:318-325).
    fx, fz = FIRE_XZ
    fire_sys = systems.make_fire_system(
        origin=(fx, ground(fx, fz) + 0.2, fz), capacity=cfg.fire_capacity)
    fire = fire_sys["create"](torch.Generator(device=device).manual_seed(seed))
    fire_draws = draws.get("fire")
    with torch.inference_mode():
        for i in range(cfg.fire_steps):
            fire = fire_sys["step"](fire, FIRE_DT, draws=None if fire_draws
                                    is None else fire_draws[i])

    options = dict(
        settings=RendererSettings(primary="raster", half_res_effects=True,
                                  enable_sss=True,
                                  enable_rt_reflections=True),
        shadow_maps=sun_maps,
        point_lights=make_point_lights([ppos], [POINT_COLOR], [POINT_RADIUS],
                                       device=device),
        point_shadow_maps=[point_map],
        spot_lights=make_spot_lights(
            [SPOT["position"]], [SPOT["direction"]], [SPOT["color"]],
            [SPOT["distance"]], [SPOT["inner_cos"]], [SPOT["outer_cos"]],
            device=device),
        spot_shadow_maps=[spot_map], probe_grid=grid,
        decals=make_decals(positions=[(2.0, ground(2.0, -3.0), -3.0)],
                           **DECAL, device=device),
        transparent_objects=[glass], water_height=WATER_HEIGHT)
    counts = dict(
        triangles=int(bvh.tri_valid.sum()), meshes=len(meshes),
        chunks=len(chunks), chunk_lods=[lod for _, lod, _ in chunks],
        trees=int(layer["count"]), tree_meshes=len(trees),
        visible_blades=int(gstats["visible_blades"]),
        visible_chunks=int(gstats["visible_chunks"]),
        lod0_blades=int(gstats["lod0_blades"]),
        lod1_blades=int(gstats["lod1_blades"]),
        envmap_peak=env_peak)
    return World(scene=scene, camera=camera, options=options, atlas=atlas,
                 fire=fire, arch=arch, bodies=bodies, body_kinds=kinds,
                 heights=heights, counts=counts, impacts=impacts)
