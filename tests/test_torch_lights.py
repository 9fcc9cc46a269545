"""The port's lights (`render/lights.py`) against the JAX package's on the
CPU: the Forward+ tile lists of `cull_lights_tiled` equal exactly (tiles
with more than MAX_LIGHTS_PER_TILE lights and sky tiles included), and
the point, spot and shadowed point shading of a JAX G-buffer within 1e-5
relative of the largest contribution."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3d12renderer_tpu.render import bvh as jbvh
from d3d12renderer_tpu.render import camera as jcam
from d3d12renderer_tpu.render import lights as jlights
from d3d12renderer_tpu.render import mesh as jmesh
from d3d12renderer_tpu.render import pathtracer as jpt
from d3d12renderer_tpu.render import shadows as jshadows
from d3d12renderer_tpu.render.gbuffer import render_gbuffer
from d3d12renderer_tpu_torch import convert
from d3d12renderer_tpu_torch.render import gbuffer as tgbuffer
from d3d12renderer_tpu_torch.render import lights

torch.set_num_threads(1)
W, H = 72, 40          # ragged: 5 x 3 tiles, the last row and column cut
# Shading sums up to 16 lights' float32 BRDF terms: 1e-5 of the largest.
SHADE_TOL = 1e-5


@pytest.fixture(scope="module")
def scene():
    meshes = [(jmesh.quad(half=20.0), 0),
              (jmesh.ico_sphere(1.0, 2).transformed(translate=(0, 1.0, 0)), 1),
              (jmesh.box((0.7, 0.7, 0.7)).transformed(
                  translate=(2.2, 0.7, -0.5)), 2)]
    mats = jpt.Materials(albedo=jnp.array([[0.5, 0.5, 0.5], [0.8, 0.2, 0.2],
                                           [0.2, 0.4, 0.8]]),
                         emissive=jnp.zeros((3, 3)),
                         roughness=jnp.array([0.8, 0.3, 0.6]),
                         metallic=jnp.array([0.0, 1.0, 0.0]))
    js = jpt.Scene(bvh=jbvh.build_bvh(meshes, cache=False), materials=mats,
                   sky=jpt.default_sky()).with_shading_table()
    cam = jcam.look_at((5, 3, 6), (0.5, 0.8, 0), aspect=W / H,
                       v_fov=math.radians(50))
    gb = render_gbuffer(js, cam, W, H)
    tgb = tgbuffer.GBuffer(**{f: torch.as_tensor(np.array(getattr(gb, f)))
                              for f in tgbuffer.GBuffer.__dataclass_fields__
                              if f not in ("overflow", "pairs")})
    return js, cam, gb, tgb


def _lights(seed, n, lo, hi, radius):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    col = rng.uniform(1.0, 8.0, (n, 3)).astype(np.float32)
    rad = rng.uniform(*radius, n).astype(np.float32)
    return jlights.make_point_lights(pos, col, rad)


@pytest.mark.parametrize("seed,n", [(0, 48), (1, 7), (2, 200)])
def test_tile_lists_equal_jax(scene, seed, n):
    """The lists and counts equal JAX's exactly: the first k passing lights
    of each tile in index order, -1 padded; some tiles pass more than
    MAX_LIGHTS_PER_TILE lights (where k = 16) and drop the same ones, and
    the sky tiles of the top row pass none."""
    js, cam, gb, _ = scene
    jl = _lights(seed, n, (-4, 0.2, -4), (4, 3, 4), (1.5, 5.0))
    want_lists, want_count = jlights.cull_lights_tiled(gb.view_pos, jl, cam,
                                                       W, H)
    got_lists, got_count = lights.cull_lights_tiled(
        torch.as_tensor(np.array(gb.view_pos)),
        convert.point_lights_from_numpy(jl, "cpu"),
        convert.camera_from_numpy(cam, "cpu"), W, H)
    np.testing.assert_array_equal(got_count.numpy(), np.asarray(want_count))
    np.testing.assert_array_equal(got_lists.numpy(), np.asarray(want_lists))
    assert got_lists.shape == (3, 5, min(n, lights.MAX_LIGHTS_PER_TILE))
    if n > lights.MAX_LIGHTS_PER_TILE:
        assert (got_count.numpy() > lights.MAX_LIGHTS_PER_TILE).any()
    assert (got_count.numpy() == 0).any() and (got_count.numpy() > 0).any()


def _close(got, want):
    want = np.asarray(want)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=SHADE_TOL,
                               atol=SHADE_TOL * np.abs(want).max())


def test_point_shading_matches_jax(scene):
    js, cam, gb, tgb = scene
    jl = _lights(3, 40, (-4, 0.2, -4), (4, 3, 4), (1.5, 5.0))
    lists, _ = jlights.cull_lights_tiled(gb.view_pos, jl, cam, W, H)
    want = jlights.shade_point_lights(gb, jl, lists, cam)
    got = lights.shade_point_lights(
        tgb, convert.point_lights_from_numpy(jl, "cpu"),
        torch.as_tensor(np.array(lists)), convert.camera_from_numpy(cam, "cpu"))
    _close(got, want)


@pytest.fixture(scope="module")
def spots():
    d = np.array([[-0.5, -0.85, -0.4], [0.3, -0.9, 0.2]])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jlights.SpotLights(
        position=jnp.array([[3.0, 5.0, 3.0], [-1.0, 4.0, -2.0]]),
        direction=jnp.asarray(d, jnp.float32),
        color=jnp.array([[45.0, 42.0, 38.0], [20.0, 30.0, 40.0]]),
        distance=jnp.array([28.0, 12.0]), inner_cos=jnp.array([0.85, 0.9]),
        outer_cos=jnp.array([0.65, 0.7]), valid=jnp.array([True, True]))


@pytest.mark.parametrize("shadowed", [False, True])
def test_spot_shading_matches_jax(scene, spots, shadowed):
    """Both spot lights, with JAX's 64^2 maps carried over (the second
    light without one) or without maps."""
    js, cam, gb, tgb = scene
    maps = None
    if shadowed:
        maps = [jshadows.render_spot_shadow_map(
            js.bvh, np.asarray(spots.position[0]),
            np.asarray(spots.direction[0]), 0.65, 28.0, resolution=64), None]
    want = jlights.shade_spot_lights(gb, spots, cam, shadow_maps=maps)
    got = lights.shade_spot_lights(
        tgb, convert.spot_lights_from_numpy(spots, "cpu"),
        convert.camera_from_numpy(cam, "cpu"),
        shadow_maps=None if maps is None else [
            convert.spot_shadow_map_from_numpy(maps[0], "cpu"), None])
    _close(got, want)
    if shadowed:
        unshadowed = jlights.shade_spot_lights(gb, spots, cam)
        assert (np.asarray(want) < np.asarray(unshadowed) - 1e-3).any()


def test_shadowed_point_shading_matches_jax(scene):
    js, cam, gb, tgb = scene
    jl = jlights.make_point_lights([[2.5, 2.0, 2.5], [-3.0, 1.5, -1.0]],
                                   [[8.0, 6.0, 4.0], [4.0, 6.0, 8.0]],
                                   [6.0, 6.0])
    pmap = jshadows.render_point_shadow_map(js.bvh, (-3.0, 1.5, -1.0), 6.0,
                                            resolution=48)
    want = jlights.shade_point_lights_shadowed(gb, jl, cam, [None, pmap])
    got = lights.shade_point_lights_shadowed(
        tgb, convert.point_lights_from_numpy(jl, "cpu"),
        convert.camera_from_numpy(cam, "cpu"),
        [None, convert.point_shadow_map_from_numpy(pmap, "cpu")])
    _close(got, want)
