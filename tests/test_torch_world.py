"""examples/showcase.py's world on the port (`terrain/heightmap.py`'s
meshes, LOD chunks and splat, `terrain/placement.py`, `terrain/grass.py`,
`terrain/tree.py`, `render/instances.py`, `scene/scene_rendering.py`,
`models/world.py` and `entry.showcase_world_entry`) against the JAX
package on the CPU, with JAX's random draws injected
(`torch_world_draws`): each module alone, then the whole world's frame at
a small size (a 17 x 17 map, 8 blades per side, 64x48, maps 32^2) against
JAX's frame of the same world under `jax.jit`."""

import dataclasses
import math
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3d12renderer_tpu.render import bvh as jbvh
from d3d12renderer_tpu.render import camera as jcam
from d3d12renderer_tpu.render import instances as jinst
from d3d12renderer_tpu.render import mesh as jmesh
from d3d12renderer_tpu.scene import scene_rendering as jsr
from d3d12renderer_tpu.terrain import grass as jgrass
from d3d12renderer_tpu.terrain import heightmap as jhm
from d3d12renderer_tpu.terrain import placement as jplace
from d3d12renderer_tpu.terrain import tree as jtree
from d3d12renderer_tpu_torch import convert, entry
from d3d12renderer_tpu_torch.models import world as tworld
from d3d12renderer_tpu_torch.ops import image, raster
from d3d12renderer_tpu_torch.render import instances as tinst
from d3d12renderer_tpu_torch.render import mesh as tmesh
from d3d12renderer_tpu_torch.scene import scene_rendering as tsr
from d3d12renderer_tpu_torch.terrain import grass as tgrass
from d3d12renderer_tpu_torch.terrain import heightmap as thm
from d3d12renderer_tpu_torch.terrain import placement as tplace
from d3d12renderer_tpu_torch.terrain import tree as ttree

import torch_world_draws as draws

torch.set_num_threads(2)
# Positions through float32 chains of a few operations (XLA fuses some
# into FMAs); normals of the LOD chunks through `jnp.gradient`.
POS_TOL = 1e-5
NORMAL_TOL = 1e-6
XFORM_TOL = 1e-6
# Whole frames (tests/test_torch_pipeline.py's criterion).
PIXEL_TOL = 1e-3
SHARE = 0.99
MEAN_TOL = 1e-3
ORIGIN = (-24.0, 0.0, -24.0)
EYE, TARGET = (0.0, 7.5, -16.0), (0.0, 1.5, 0.0)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def heights33():
    """A 33 x 33 map over the showcase's 48 m (cell 1.5)."""
    return np.asarray(jhm.generate_heightmap(33, 48.0, 5.0, 0.06, seed=7))


@pytest.mark.parametrize("lod_distances", [(24.0, 48.0, 96.0),
                                           (6.0, 12.0, 24.0)])
def test_terrain_lod_chunks_match_jax(heights33, lod_distances):
    """Chunks of 8 cells: the same LOD per chunk, positions, uvs and
    indices equal, normals within NORMAL_TOL; every seam watertight (a
    finer edge's vertices on the coarser edge's polyline,
    tests/test_terrain_lod_splat.py:33)."""
    kw = dict(chunk_cells=8, camera_pos=EYE, lod_distances=lod_distances)
    want = jhm.terrain_lod_chunks(heights33, ORIGIN, 1.5, **kw)
    got = thm.terrain_lod_chunks(heights33, ORIGIN, 1.5, **kw)
    assert [(lod, cc) for _, lod, cc in got] == [(lod, cc) for _, lod, cc
                                                 in want]
    assert len({lod for _, lod, _ in got}) >= 2
    for (a, _, _), (b, _, _) in zip(got, want):
        for f in ("positions", "uvs", "indices"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        np.testing.assert_allclose(a.normals, b.normals, rtol=0,
                                   atol=NORMAL_TOL)
    by_cc = {cc: mesh for mesh, _, cc in got}
    checked = 0
    for (ci, cj), mesh in by_cc.items():
        for nb, axis in (((ci + 1, cj), 0), ((ci, cj + 1), 2)):
            if nb not in by_cc:
                continue
            bound = ORIGIN[axis] + (nb[0] if axis == 0 else nb[1]) * 8 * 1.5
            t_axis = 2 if axis == 0 else 0
            ea, eb = (m.positions[np.abs(m.positions[:, axis] - bound) < 1e-4]
                      for m in (mesh, by_cc[nb]))
            fine, coarse = (ea, eb) if len(ea) >= len(eb) else (eb, ea)
            coarse = coarse[np.argsort(coarse[:, t_axis])]
            y = np.interp(fine[:, t_axis], coarse[:, t_axis], coarse[:, 1])
            np.testing.assert_allclose(fine[:, 1], y, rtol=0, atol=1e-4)
            checked += 1
    assert checked == 24


def test_heightmap_mesh_normals_and_splat_match_jax(heights33):
    """`heightmap_normals` of float32 heights, `heightmap_mesh` (positions
    and indices equal) and the splat texture within 1e-6."""
    want = jhm.heightmap_mesh(heights33, ORIGIN, 1.5)
    got = thm.heightmap_mesh(heights33, ORIGIN, 1.5)
    for f in ("positions", "uvs", "indices"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    np.testing.assert_allclose(got.normals, want.normals, rtol=0,
                               atol=NORMAL_TOL)
    jw = jhm.splat_weights(jnp.asarray(heights33), 1.5)
    tw = thm.splat_weights(heights33, 1.5)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        thm.shade_splat(tw, tworld.SPLAT_ALBEDOS).numpy(),
        np.asarray(jhm.shade_splat(jw, tworld.SPLAT_ALBEDOS)), rtol=0,
        atol=1e-6)
    assert float(tw[..., 1].max()) > 0.5       # some rock on the slopes


def _assert_points(got, want):
    for f in ("valid", "order"):
        np.testing.assert_array_equal(_np(got[f]), np.asarray(want[f]))
    assert int(got["count"]) == int(want["count"])
    for f in ("position", "normal", "rotation", "scale"):
        np.testing.assert_allclose(_np(got[f]), np.asarray(want[f]), rtol=0,
                                   atol=POS_TOL, err_msg=f)


def test_placement_matches_jax(heights33):
    """Two layers with three weighted mesh variants on one grid: order,
    valid, count and mesh_index equal, positions, rotations and scales
    within POS_TOL; the instantiated meshes within POS_TOL."""
    layers = [dict(max_height=3.0, max_slope_y=0.6, density=0.4,
                   mesh_weights=[1.0, 2.0, 1.0], scale_range=(0.8, 1.2)),
              dict(min_height=-1.0, density=0.7)]
    key = jax.random.PRNGKey(11)
    n = 16 * 16
    want = jplace.generate_placement_layers(
        jnp.asarray(heights33), ORIGIN, 1.5, 48.0, key, layers,
        points_per_side=16)
    got = tplace.generate_placement_layers(
        torch.from_numpy(heights33.copy()), ORIGIN, 1.5, 48.0, layers,
        points_per_side=16, draws=draws.placement_layers(key, n, 2))
    for g, w in zip(got, want):
        _assert_points(g, w)
        np.testing.assert_array_equal(g["mesh_index"].numpy(),
                                      np.asarray(w["mesh_index"]))
    assert int(got[0]["count"]) > 0 and int(got[1]["count"]) > 0
    assert set(got[0]["mesh_index"].tolist()) == {0, 1, 2}
    protos = [tmesh.box((0.2, 1.0, 0.2)), tmesh.ico_sphere(0.5, 1),
              tmesh.cylinder(0.1, 0.5, slices=6)]
    jprotos = [jmesh.box((0.2, 1.0, 0.2)), jmesh.ico_sphere(0.5, 1),
               jmesh.cylinder(0.1, 0.5, slices=6)]
    tm = tplace.instantiate_placement(got[0], protos, [1, 2, 3], 6)
    jm = jplace.instantiate_placement(want[0], jprotos, [1, 2, 3], 6)
    assert [m for _, m in tm] == [m for _, m in jm] and len(tm) == 6
    for (a, _), (b, _) in zip(tm, jm):
        np.testing.assert_allclose(a.positions, b.positions, rtol=0,
                                   atol=POS_TOL)
        np.testing.assert_array_equal(a.indices, b.indices)


def test_grass_matches_jax(heights33):
    """Blades from JAX's draws, then `grass_lod_triangles` against a 16:9
    camera: valid and count equal, vertices within POS_TOL, triangles and
    stats equal; some chunks culled, both LOD classes present."""
    key = jax.random.PRNGKey(3)
    n = 20 * 20
    jb = jgrass.generate_grass_blades(jnp.asarray(heights33), ORIGIN, 1.5,
                                      48.0, key, blades_per_side=20,
                                      density=0.6)
    tb = tgrass.generate_grass_blades(torch.as_tensor(heights33), ORIGIN,
                                      1.5, 48.0, blades_per_side=20,
                                      density=0.6, draws=draws.grass(key, n))
    for f in ("position", "facing", "height"):
        np.testing.assert_allclose(_np(tb[f]), np.asarray(jb[f]), rtol=0,
                                   atol=POS_TOL)
    np.testing.assert_array_equal(tb["valid"].numpy(), np.asarray(jb["valid"]))
    cam = jcam.look_at(EYE, TARGET, aspect=16 / 9, v_fov=math.radians(50))
    jv, jt, js = jax.jit(lambda b: jgrass.grass_lod_triangles(
        b, cam, ORIGIN, 48.0, time=0.4, lod_distance=18.0))(jb)
    tv, tt, ts = tgrass.grass_lod_triangles(
        tb, convert.camera_from_numpy(cam, "cpu"), ORIGIN, 48.0, time=0.4,
        lod_distance=18.0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                               atol=POS_TOL)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    stats = {k: int(v) for k, v in ts.items()}
    assert stats == {k: int(v) for k, v in js.items()}
    assert 0 < stats["visible_blades"] < int(tb["count"])
    assert stats["lod0_blades"] > 0 and stats["lod1_blades"] > 0


def test_frustum_planes_and_culling_match_jax():
    """Planes within 1e-6 (float64 on the host, then float32); the
    visibility of 500 random spheres equal."""
    cam = jcam.look_at(EYE, TARGET, aspect=16 / 9, v_fov=math.radians(50))
    want = np.asarray(jsr.frustum_planes(cam))
    got = tsr.frustum_planes(convert.camera_from_numpy(cam, "cpu"))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    rng = np.random.default_rng(2)
    c = rng.uniform(-30, 30, (500, 3)).astype(np.float32)
    r = rng.uniform(0.1, 4, 500).astype(np.float32)
    vis = tsr.cull_spheres(got, torch.as_tensor(c), torch.as_tensor(r))
    np.testing.assert_array_equal(vis.numpy(), np.asarray(jsr.cull_spheres(
        jnp.asarray(want), jnp.asarray(c), jnp.asarray(r))))
    assert 0 < int(vis.sum()) < 500


def test_instancing_and_render_submission_match_jax():
    """`build_instanced` buffers equal (the same 512-row padding);
    `retransform` at random poses within XFORM_TOL, its one-leaf BVH's
    closest hits equal to a BVH built from the posed meshes; a
    RenderSubmission of each package's `scene.Scene`, both built from one
    spec, with a culled entity."""
    from d3d12renderer_tpu.scene import components as JC
    from d3d12renderer_tpu.scene.scene import Scene as JScene
    from types import SimpleNamespace

    from d3d12renderer_tpu_torch.render import bvh as tbvh
    from d3d12renderer_tpu_torch.scene import components as TC
    from d3d12renderer_tpu_torch.scene.scene import Scene as TScene

    meshes_t = [(tmesh.box((0.5, 0.3, 0.2)), 1), (tmesh.ico_sphere(0.4, 1), 2)]
    meshes_j = [(jmesh.box((0.5, 0.3, 0.2)), 1), (jmesh.ico_sphere(0.4, 1), 2)]
    inst = [0, 1, 1, 0]
    ji = jinst.build_instanced(meshes_j, inst)
    ti = tinst.build_instanced(meshes_t, inst, "cpu")
    for f in dataclasses.fields(ti):
        np.testing.assert_array_equal(getattr(ti, f.name).numpy(),
                                      np.asarray(getattr(ji, f.name)))
    rng = np.random.default_rng(5)
    pos = rng.uniform(-2, 2, (4, 3)).astype(np.float32)
    rot = rng.normal(size=(4, 4)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
    scl = np.array([1.0, 0.5, 1.5, 0.0], np.float32)
    jb = jinst.retransform(ji, jnp.asarray(pos), jnp.asarray(rot),
                           jnp.asarray(scl))
    tb = tinst.retransform(ti, torch.as_tensor(pos), torch.as_tensor(rot),
                           torch.as_tensor(scl))
    for f in ("tri_v0", "tri_e1", "tri_e2", "tri_n0", "tri_n1", "tri_n2"):
        np.testing.assert_allclose(getattr(tb, f).numpy(),
                                   np.asarray(getattr(jb, f)), rtol=0,
                                   atol=XFORM_TOL, err_msg=f)
    for f in ("n", "n_off", "e1p", "e1_off", "e2p", "e2_off"):
        np.testing.assert_allclose(getattr(tb.dense, f).numpy(),
                                   np.asarray(getattr(jb.dense, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    posed = [(m.transformed(translate=tuple(pos[i]), rotate=tuple(rot[i]),
                            scale=float(scl[i])), k)
             for i, (m, k) in enumerate(meshes_t[j] for j in inst)]
    ref = tbvh.build_bvh(posed[:3], device="cpu")
    o = torch.tensor([[0.0, 0.0, 8.0]]).expand(400, 3).contiguous()
    d = torch.as_tensor(rng.normal(size=(400, 3)).astype(np.float32) * 0.2
                        + np.array([0, 0, -1], np.float32))
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    got, want = tbvh.closest_hit(tb, o, d), tbvh.closest_hit(ref, o, d)
    np.testing.assert_array_equal(got["hit"].numpy(), want["hit"].numpy())
    np.testing.assert_allclose(got["t"][got["hit"]].numpy(),
                               want["t"][want["hit"]].numpy(), rtol=1e-5)
    assert 0 < int(got["hit"].sum()) < 400

    # render_bodies: the path-traced image of the retransformed instances.
    from d3d12renderer_tpu_torch.render import pathtracer as tpt

    mats = tpt.Materials(albedo=torch.rand(3, 3), emissive=torch.zeros(3, 3),
                         roughness=torch.full((3,), 0.5),
                         metallic=torch.zeros(3))
    sky = tpt.default_sky(device="cpu")
    tcam = convert.camera_from_numpy(jcam.look_at((0.0, 1.0, 8.0),
                                                  (0.0, 0.0, 0.0)), "cpu")
    bodies = SimpleNamespace(pos=torch.as_tensor(pos),
                             rot=torch.as_tensor(rot))
    img, rays = tinst.render_bodies(
        ti, bodies, mats, sky, tcam, 16, 12, spp=1,
        sampler=tpt.Sampler(torch.Generator().manual_seed(2)))
    want, _ = tpt.render(
        tpt.Scene(bvh=tinst.retransform(ti, bodies.pos, bodies.rot),
                  materials=mats, sky=sky), tcam, 16, 12,
        tpt.PathTracerSettings(recursion_depth=2), spp=1,
        sampler=tpt.Sampler(torch.Generator().manual_seed(2)))
    assert img.shape == (12, 16, 3) and torch.equal(img, want)
    assert int(rays) >= 16 * 12 and float(img.std()) > 0

    spec = (("a", "box", {"half_extents": (0.5,) * 3}, (0.0, 0.5, 0.0)),
            ("b", "sphere", {"radius": 0.5}, (1.5, 0.5, 1.0)),
            ("c", "box", {"half_extents": (0.3,) * 3}, (0.0, 0.5, -30.0)))
    js, ts = JScene(), TScene()
    for sc, C in ((js, JC), (ts, TC)):
        for name, prim, params, p in spec:
            e = sc.create_entity(name)
            e.add_component(C.Transform(position=p))
            e.add_component(C.Mesh(primitive=prim, params=params))
            if name == "b":
                e.add_component(C.Material(albedo=(0.9, 0.1, 0.1),
                                           metallic=1.0))
    jsub = jsr.RenderSubmission(js)
    tsub = tsr.RenderSubmission(ts, device="cpu")
    for f in dataclasses.fields(tsub.instanced):
        np.testing.assert_array_equal(getattr(tsub.instanced, f.name).numpy(),
                                      np.asarray(getattr(jsub.instanced,
                                                         f.name)))
    for f in ("albedo", "emissive", "roughness", "metallic"):
        np.testing.assert_array_equal(getattr(tsub.materials, f).numpy(),
                                      np.asarray(getattr(jsub.materials, f)))
    cam = jcam.look_at((0.0, 3.0, -8.0), (0.0, 0.5, 0.0), aspect=1.0)
    bpos = np.array([[0.0, 2.0, 0.0]], np.float32)
    brot = np.array([[0.0, 0.0, 0.0, 1.0]], np.float32)
    mapping = {tsub.entity_ids[0]: 0}
    jp, jr = jsub.instance_poses(SimpleNamespace(
        pos=jnp.asarray(bpos), rot=jnp.asarray(brot)), mapping)
    tp, tr = tsub.instance_poses(SimpleNamespace(
        pos=torch.as_tensor(bpos), rot=torch.as_tensor(brot)), mapping)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    jbvh_, jvis = jsub.visible_bvh(cam, jp, jr)
    tbvh_, tvis = tsub.visible_bvh(convert.camera_from_numpy(cam, "cpu"),
                                   tp, tr)
    np.testing.assert_array_equal(tvis.numpy(), np.asarray(jvis))
    assert tvis.tolist() == [True, True, False]
    np.testing.assert_allclose(tbvh_.tri_v0.numpy(), np.asarray(jbvh_.tri_v0),
                               rtol=0, atol=XFORM_TOL)


def test_tree_wind_bend_and_weld_match_jax():
    rng = np.random.default_rng(6)
    p = rng.uniform(-2, 4, (300, 3)).astype(np.float32)
    np.testing.assert_allclose(
        ttree.wind_bend(torch.as_tensor(p), 1.7).numpy(),
        np.asarray(jtree.wind_bend(jnp.asarray(p), 1.7)), rtol=0,
        atol=POS_TOL)
    m = tmesh.ico_sphere(1.0, 1)
    soup = m.positions[m.indices.reshape(-1)]
    idx = np.arange(len(soup), dtype=np.int32).reshape(-1, 3)
    got = ttree.weld_vertices(soup, idx)
    want = jtree.weld_vertices(soup, idx)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert len(got[0]) == len(m.positions)


# The whole world, small: a 17 x 17 map (one chunk), 8 blades per side,
# 2 physics frames, maps of 32^2 in a 256 atlas, 8 probe rays, a 32^2
# cubemap, 45 fire steps.
SMALL = tworld.WorldConfig(resolution=17, grass_per_side=8, physics_frames=2,
                           atlas_size=256, sun_resolution=32,
                           spot_resolution=32, point_resolution=32,
                           probe_rays=8, envmap_face=32)
W, H = 64, 48


def _jax_world(heights, poses, kinds, envmap, cfg, w, h):
    """examples/showcase.py:93-325's world built by the JAX package at
    `cfg`'s sizes, with the port's settled body poses: (scene, camera,
    render_frame options, fire pool)."""
    from d3d12renderer_tpu.assets.cache import load_image_cached
    from d3d12renderer_tpu.assets.envmap import DEFAULT_SUN
    from d3d12renderer_tpu.particles import systems as jsys
    from d3d12renderer_tpu.render import decals as jdecals
    from d3d12renderer_tpu.render import light_probe as jprobe
    from d3d12renderer_tpu.render import lights as jlights
    from d3d12renderer_tpu.render import pathtracer as jpt
    from d3d12renderer_tpu.render import shadows as jshadows
    from d3d12renderer_tpu.render import transparent as jtransparent
    from d3d12renderer_tpu.render.ibl import equirect_to_cubemap

    cell = 48.0 / (cfg.resolution - 1)
    hj = jnp.asarray(heights)

    def sample_h(x, z):
        return float(jhm.sample_height_bilinear(hj, ORIGIN, cell,
                                                jnp.asarray(x),
                                                jnp.asarray(z))[0])

    chunks = jhm.terrain_lod_chunks(heights, ORIGIN, cell,
                                    chunk_cells=cfg.chunk_cells,
                                    camera_pos=EYE)
    splat = jhm.shade_splat(jhm.splat_weights(hj, cell), tworld.SPLAT_ALBEDOS)
    meshes = [(m, 0) for m, _, _ in chunks]
    layer = jplace.generate_placement_layers(
        hj, ORIGIN, cell, 48.0, jax.random.PRNGKey(11), [tworld.TREE_LAYER],
        points_per_side=cfg.tree_points_per_side)[0]
    trunk = jmesh.cylinder(0.18, 1.2, slices=8).transformed(
        translate=(0.0, 1.2, 0.0))
    canopy = jmesh.ico_sphere(1.0, 1).transformed(translate=(0.0, 2.8, 0.0))
    meshes += jplace.instantiate_placement(layer, [trunk], [2],
                                           cfg.tree_max_instances)
    meshes += jplace.instantiate_placement(layer, [canopy], [3],
                                           cfg.tree_max_instances)
    blades = jgrass.generate_grass_blades(
        hj, ORIGIN, cell, 48.0, jax.random.PRNGKey(3),
        blades_per_side=cfg.grass_per_side, density=cfg.grass_density)
    cam = jcam.look_at(EYE, TARGET, aspect=w / h, v_fov=math.radians(50))
    gv, gt, _ = jax.jit(lambda b: jgrass.grass_lod_triangles(
        b, cam, ORIGIN, 48.0, time=cfg.grass_time,
        lod_distance=cfg.grass_lod_distance))(blades)
    gv = np.asarray(gv, np.float32)
    meshes.append((jmesh.MeshData(
        positions=gv, normals=np.tile(np.array([[0, 1, 0]], np.float32),
                                      (len(gv), 1)),
        uvs=np.zeros((len(gv), 2), np.float32),
        indices=np.asarray(gt, np.int32)), 4))
    for kind, p, q in zip(kinds, *poses):
        if kind == "box":
            meshes.append((jmesh.box((0.45,) * 3).transformed(
                translate=tuple(p), rotate=tuple(q)), 5))
        else:
            meshes.append((jmesh.ico_sphere(0.45, 2).transformed(
                translate=tuple(p)), 6))
    bvh = jbvh.build_bvh(meshes, cache=False)
    mats = jpt.Materials(
        albedo=jnp.array(tworld.ALBEDO), emissive=jnp.zeros((7, 3)),
        roughness=jnp.array(tworld.ROUGHNESS),
        metallic=jnp.array(tworld.METALLIC),
        texture_atlas=jnp.asarray(np.asarray(splat), jnp.float32)[None],
        albedo_texture=jnp.array([0, -1, -1, -1, -1, -1, -1], jnp.int32))
    env = jnp.asarray(load_image_cached(envmap)[0][0])
    sun = np.asarray(DEFAULT_SUN) / np.linalg.norm(DEFAULT_SUN)
    sky = jpt.default_sky().replace(
        cubemap=equirect_to_cubemap(env, cfg.envmap_face),
        sun_direction=jnp.asarray(sun, jnp.float32))
    scene = jpt.Scene(bvh=bvh, materials=mats, sky=sky).with_shading_table()
    atlas = jshadows.ShadowAtlas(size=cfg.atlas_size)
    sun_maps = atlas.update_sun(bvh, jnp.asarray(EYE), -sky.sun_direction,
                                resolution=cfg.sun_resolution)
    spot = tworld.SPOT
    smap = atlas.update_spot(bvh, 0, spot["position"], spot["direction"],
                             0.65, 28.0, resolution=cfg.spot_resolution)
    ppos = (-4.0, sample_h(-4.0, 2.0) + 2.5, 2.0)
    pmap = atlas.update_point(bvh, 0, ppos, 16.0,
                              resolution=cfg.point_resolution)
    sd = np.array([spot["direction"]])
    grid = jprobe.create_probe_grid(**tworld.PROBES)
    update = jax.jit(lambda g, k: jprobe.update_probes(
        g, scene, k, rays_per_probe=cfg.probe_rays))
    for i in range(cfg.probe_updates):
        grid = update(grid, jax.random.PRNGKey(40 + i))
    gx, gz = tworld.GLASS_XZ
    fx, fz = tworld.FIRE_XZ
    fire = jsys.make_fire_system(origin=(fx, sample_h(fx, fz) + 0.2, fz),
                                 capacity=cfg.fire_capacity)
    pool = fire["create"](jax.random.PRNGKey(9))
    step = jax.jit(lambda s: fire["step"](s, 1 / 60.0))
    for _ in range(cfg.fire_steps):
        pool = step(pool)
    options = dict(
        point_lights=jlights.make_point_lights([ppos], [tworld.POINT_COLOR],
                                               [tworld.POINT_RADIUS]),
        spot_lights=jlights.SpotLights(
            position=jnp.array([spot["position"]]),
            direction=jnp.asarray(sd / np.linalg.norm(sd)),
            color=jnp.array([spot["color"]]), distance=jnp.array([28.0]),
            inner_cos=jnp.array([0.85]), outer_cos=jnp.array([0.65]),
            valid=jnp.array([True])),
        shadow_maps=sun_maps, spot_shadow_maps=[smap],
        point_shadow_maps=[pmap], probe_grid=grid,
        transparent_objects=[jtransparent.TransparentObject(
            bvh=jbvh.build_bvh([(jmesh.box(tworld.GLASS_HALF).transformed(
                translate=(gx, sample_h(gx, gz) + 1.2, gz)), 0)], cache=False),
            color=tworld.GLASS_COLOR, alpha=tworld.GLASS_ALPHA)],
        decals=jdecals.make_decals(
            positions=[(2.0, sample_h(2.0, -3.0), -3.0)], **tworld.DECAL),
        water_height=tworld.WATER_HEIGHT)
    return scene, cam, options, jax.device_get(pool)


def test_whole_world_frame_matches_jax(tmp_path):
    """`showcase_world_entry` at SMALL on the CPU, with JAX's heights and
    draws (trees, grass, probe turns, fire emissions), against the same
    world built by the JAX package from the port's settled bodies: the
    counts equal; two frames (raster primary, half-res effects, SSS, RT
    reflections, every light, map, probe, decal, glass and water, TAA
    history carried) with the particles splatted after, each with at least
    SHARE of pixels within PIXEL_TOL and the mean error below MEAN_TOL; the
    sky and the splat each change the frame; no kernel launched."""
    from d3d12renderer_tpu.render import pipeline as jpipe
    from d3d12renderer_tpu_torch.particles.systems import splat_particles
    from test_torch_particles import _jax_splat

    envmap = str(tmp_path / "studio.hdr")
    shutil.copy(tworld.ENVMAP, envmap)
    cfg = SMALL
    heights = np.asarray(jhm.generate_heightmap(
        cfg.resolution, 48.0, 5.0, 0.06, seed=7))
    n_trees = cfg.tree_points_per_side ** 2
    injected = {
        "trees": draws.placement_layers(jax.random.PRNGKey(11), n_trees, 1),
        "grass": draws.grass(jax.random.PRNGKey(3), cfg.grass_per_side ** 2),
        "probes": [np.asarray(jax.random.uniform(jax.random.PRNGKey(40 + i)))
                   for i in range(cfg.probe_updates)],
        "fire": draws.emissions("fire", jax.random.PRNGKey(9),
                                cfg.fire_steps),
    }
    before = (image.gaussian_blur.launches, image.tonemap.launches,
              raster.rasterize_tiles.launches)
    fn, state = entry.showcase_world_entry(
        device="cpu", width=W, height=H, config=cfg, envmap=envmap,
        draws=injected, heights=heights)
    world = fn.world
    poses = (world.bodies.pos[0].numpy(), world.bodies.rot[0].numpy())
    js, jc, jopts, jpool = _jax_world(heights, poses, world.body_kinds,
                                      envmap, cfg, W, H)
    np.testing.assert_array_equal(fn.world.fire.alive.numpy(), jpool.alive)
    np.testing.assert_allclose(fn.world.fire.position.numpy(),
                               jpool.position, rtol=0, atol=POS_TOL)
    assert world.counts["triangles"] == int(np.asarray(js.bvh.tri_valid).sum())
    np.testing.assert_allclose(world.scene.sky.cubemap.numpy(),
                               np.asarray(js.sky.cubemap), rtol=0, atol=0)
    np.testing.assert_allclose(world.scene.materials.texture_atlas.numpy(),
                               np.asarray(js.materials.texture_atlas),
                               rtol=0, atol=1e-6)

    settings = jpipe.RendererSettings(primary="raster", half_res_effects=True,
                                      enable_sss=True,
                                      enable_rt_reflections=True)
    frame = jax.jit(lambda st, k: jpipe.render_frame(
        js, jc, W, H, settings, frame_state=st, prev_camera=jc, key=k,
        **jopts)[:2])
    color = jnp.array(tworld.PARTICLE_COLOR)
    jst = jpipe.initial_frame_state(W, H)
    for i, key in enumerate((jax.random.PRNGKey(3), jax.random.PRNGKey(4))):
        jldr, jst = frame(jst, key)
        want = np.asarray(_jax_splat(jldr, jc, jpool.position, jpool.alive,
                                     color))
        jitter = torch.as_tensor(np.array(jax.random.uniform(key, (2,))))
        ldr, state, aux = fn(state, jitter=jitter)
        assert ldr.shape == (H, W, 3) and bool(torch.isfinite(ldr).all())
        err = np.abs(ldr.numpy() - want).max(-1)
        share = (err <= PIXEL_TOL).mean()
        assert share >= SHARE and err.mean() < MEAN_TOL, (i, share,
                                                          err.mean())
    assert int(state.frame_index) == 2
    assert float((ldr - aux["frame_ldr"]).abs().max()) > 0.1
    np.testing.assert_array_equal(
        splat_particles(aux["frame_ldr"], fn.camera, world.fire.position,
                        world.fire.alive, torch.tensor(
                            tworld.PARTICLE_COLOR)).numpy(), ldr.numpy())
    procedural = dataclasses.replace(
        fn.scene, sky=tworld.load_sky("cpu", cfg.envmap_face, None)[0])
    other, _, _ = fn(state, jitter=jitter, scene=procedural)
    assert float((other - ldr).abs().amax(-1).gt(PIXEL_TOL).float().mean()) \
        > 0.05
    assert (image.gaussian_blur.launches, image.tonemap.launches,
            raster.rasterize_tiles.launches) == before
