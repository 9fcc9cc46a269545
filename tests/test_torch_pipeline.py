"""The port's raster frame (`render/pipeline.py` and the G-buffer, shadow
and camera modules under it) against the JAX package on the CPU, two whole
frames with carried state included, and with every option of the frame
(each alone and all together); the raster primary against the ray primary
on the port; and the main path's entry at a tiny size.  Jitter is computed on the JAX side
(`jax.random.uniform(key, (2,))`, as `render_gbuffer` draws it) and handed
to the port."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3d12renderer_tpu.ops import raster_pallas as rp
from d3d12renderer_tpu.render import bvh as jbvh
from d3d12renderer_tpu.render import camera as jcam
from d3d12renderer_tpu.render import mesh as jmesh
from d3d12renderer_tpu.render import pathtracer as jpt
from d3d12renderer_tpu.render import pipeline as jpipe
from d3d12renderer_tpu.render import shadows as jshadows
from d3d12renderer_tpu.render.gbuffer import render_gbuffer as j_gbuffer
from d3d12renderer_tpu_torch import convert, entry
from d3d12renderer_tpu_torch.ops import image, raster
from d3d12renderer_tpu_torch.render import camera as tcam
from d3d12renderer_tpu_torch.render import pathtracer as tpt
from d3d12renderer_tpu_torch.render import pipeline as tpipe
from d3d12renderer_tpu_torch.render import shadows as tshadows
from d3d12renderer_tpu_torch.render.gbuffer import render_gbuffer

torch.set_num_threads(1)
W = H = 128
SHADOW_RES = 128
# Whole frames: one flipped edge pixel or shadow-map texel changes a pixel
# by up to ~0.1, so frames are compared pixel by pixel (the path tracer's
# criterion, tests/test_torch_pathtracer.py).
PIXEL_TOL = 1e-3
SHARE = 0.99
MEAN_TOL = 1e-4


def _meshes(mm):
    return [(mm.quad(half=20.0), 0),
            (mm.ico_sphere(1.0, 3).transformed(translate=(0, 1.0, 0)), 1),
            (mm.box((0.7, 0.7, 0.7)).transformed(translate=(2.2, 0.7, -0.5)), 2)]


MATERIALS = dict(
    albedo=np.array([[0.5, 0.5, 0.5], [0.8, 0.2, 0.2], [0.2, 0.4, 0.8]],
                    np.float32),
    emissive=np.array([[0, 0, 0], [0, 0, 0], [0.4, 0.2, 0.0]], np.float32),
    roughness=np.array([0.8, 0.3, 0.6], np.float32),
    metallic=np.array([0.0, 1.0, 0.0], np.float32))


@pytest.fixture(scope="module")
def scenes():
    bvh = jbvh.build_bvh(_meshes(jmesh), cache=False)
    mats = jpt.Materials(**{k: jnp.asarray(v) for k, v in MATERIALS.items()})
    js = jpt.Scene(bvh=bvh, materials=mats,
                   sky=jpt.default_sky()).with_shading_table()
    ts = tpt.Scene(bvh=convert.bvh_from_numpy(bvh, "cpu"),
                   materials=convert.materials_from_numpy(mats, "cpu"),
                   sky=convert.sky_from_numpy(js.sky, "cpu")).with_shading_table()
    cam = jcam.look_at((5, 3, 6), (0.5, 0.8, 0), aspect=W / H,
                       v_fov=math.radians(50))
    return js, ts, cam


@pytest.fixture(scope="module")
def jax_maps(scenes):
    js, _, cam = scenes
    maps = jshadows.fit_cascades(cam.position, -js.sky.sun_direction)
    return jax.jit(lambda m: jshadows.render_sun_shadow_maps(
        js.bvh, m, resolution=SHADOW_RES))(maps)


def _jitter(key):
    return np.array(jax.random.uniform(key, (2,)))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_halton_and_offset_rays_match_jax(scenes):
    for i in range(1, 9):
        assert tcam.halton(i, 2) == jcam.halton(i, 2)
        assert tcam.halton(i, 3) == jcam.halton(i, 3)
    _, _, cam = scenes
    off = (0.3, 0.8)
    want = jcam.generate_rays(cam, 24, 16, offset=jnp.asarray(off))
    got = tcam.generate_rays(convert.camera_from_numpy(cam, "cpu"), 24, 16,
                             offset=off)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-6)


def test_cascades_and_shadow_maps_match_jax(scenes):
    """`fit_cascades` to float rounding; 3 cascades at 64^2 through
    `closest_hit` (the plain ray version here): the same texels hit, depths
    within 1e-5 relative except where a ray grazes an edge."""
    js, ts, cam = scenes
    want = jshadows.fit_cascades(cam.position, -js.sky.sun_direction)
    got = tshadows.fit_cascades(convert.camera_from_numpy(cam, "cpu").position,
                                -ts.sky.sun_direction)
    for f in ("origin", "right", "up", "direction", "extent", "z_range"):
        np.testing.assert_allclose(_np(getattr(got, f)), _np(getattr(want, f)),
                                   rtol=1e-6, atol=1e-5, err_msg=f)
    want = _np(jax.jit(lambda m: jshadows.render_sun_shadow_maps(
        js.bvh, m, resolution=64))(want).depth)
    got = _np(tshadows.render_sun_shadow_maps(ts.bvh, got, resolution=64).depth)
    fin = np.isfinite(want)
    assert 0.2 < fin.mean() < 1.0
    assert (np.isfinite(got) != fin).mean() < 2e-3
    both = fin & np.isfinite(got)
    rel = np.abs(got[both] - want[both]) / want[both]
    assert (rel <= 1e-5).mean() > 0.999


def test_sample_sun_shadow_matches_jax(scenes, jax_maps):
    """JAX's cascades carried over (`sun_shadow_maps_from_numpy`): the same
    cascade and the same 3x3 PCF factor at points around the scene, except
    where a tap lies within float rounding of its depth."""
    rng = np.random.default_rng(3)
    pts = rng.uniform([-12, -0.5, -12], [12, 3, 12], (4000, 3)).astype(np.float32)
    lit_j, cas_j = jshadows.sample_sun_shadow(jax_maps, jnp.asarray(pts))
    maps = convert.sun_shadow_maps_from_numpy(jax_maps, "cpu")
    lit, cas = tshadows.sample_sun_shadow(maps, torch.as_tensor(pts))
    np.testing.assert_array_equal(_np(cas), _np(cas_j))
    assert len(np.unique(_np(cas))) >= 3
    assert (np.abs(_np(lit) - _np(lit_j)) > 1e-6).mean() < 2e-3
    assert 0.05 < (_np(lit) < 1).mean() < 0.95


def _gbuffer_pair(scenes, primary, monkeypatch):
    js, ts, cam = scenes
    key = jax.random.PRNGKey(5)
    prev = cam.replace(position=cam.position + jnp.array([0.3, 0.0, -0.2]))
    want = j_gbuffer(js, cam, W, H, prev_camera=prev, jitter_key=key,
                     primary=primary)
    tcam_, tprev = (convert.camera_from_numpy(c, "cpu") for c in (cam, prev))
    if primary == "raster":
        mat, attr = rp.perspective_rows(cam, W, H)
        monkeypatch.setattr(raster, "perspective_rows", lambda *a: (
            torch.as_tensor(np.array(mat)), torch.as_tensor(np.array(attr))))
        got = render_gbuffer(ts, tcam_, W, H, prev_camera=tprev,
                             jitter=torch.as_tensor(_jitter(key)),
                             primary="raster")
    else:
        # JAX's per-pixel offsets (generate_rays: split, then uniform).
        off = jax.random.uniform(jax.random.split(key)[1], (H, W, 2))

        class Offsets:
            def uniform(self, shape):
                assert tuple(shape) == (H, W, 2)
                return torch.as_tensor(np.array(off))

        got = render_gbuffer(ts, tcam_, W, H, prev_camera=tprev,
                             sampler=Offsets(), primary="ray")
    return got, want


@pytest.mark.parametrize("primary", ["raster", "ray"])
def test_gbuffer_matches_jax(scenes, primary, monkeypatch):
    """Every field of the G-buffer, raster primary (on JAX's camera rows,
    as tests/test_torch_raster.py explains) and ray primary (JAX's
    per-pixel offsets): `hit` and `object_id` equal except at a few edge
    pixels; where both hit the same material, positions within 1e-4 of the
    scene's scale, normals and material values within 1e-4, motion within
    1e-3 pixel."""
    got, want = _gbuffer_pair(scenes, primary, monkeypatch)
    hit, whit = _np(got.hit), _np(want.hit)
    assert 0.2 < whit.mean() < 0.95
    assert (hit != whit).mean() < 2e-3
    same = hit & whit & (_np(got.object_id) == _np(want.object_id))
    assert same.sum() > 0.99 * whit.sum()
    for f, tol in (("depth", 1e-4), ("world_pos", 1e-4), ("view_pos", 1e-4),
                   ("normal", 1e-4), ("view_normal", 1e-4), ("albedo", 1e-6),
                   ("roughness", 1e-6), ("metallic", 1e-6),
                   ("emissive", 1e-6), ("motion", 1e-3)):
        a, b = _np(getattr(got, f))[same], _np(getattr(want, f))[same]
        err = np.abs(a - b)
        # A pixel on a shading-normal seam may take the other triangle's
        # interpolation: at most a few.
        assert (err > tol * np.maximum(1.0, np.abs(b))).mean() < 2e-3, f
    miss = ~hit & ~whit
    assert np.all(np.isinf(_np(got.depth)[miss]))
    np.testing.assert_array_equal(_np(got.object_id)[miss], -1)


def _jax_frames(scenes, jax_maps, settings, keys):
    js, _, cam = scenes
    fn = jax.jit(lambda st, k: jpipe.render_frame(
        js, cam, W, H, settings, shadow_maps=jax_maps, frame_state=st,
        prev_camera=cam, key=k)[:2])
    st, out = jpipe.initial_frame_state(W, H), []
    for k in keys:
        ldr, st = fn(st, k)
        out.append((np.asarray(ldr), jax.device_get(st)))
    return out


def _compare_frames(got, want):
    err = np.abs(_np(got) - want).max(-1)
    share = (err <= PIXEL_TOL).mean()
    assert share >= SHARE and err.mean() < MEAN_TOL, (share, err.mean())


def test_two_frames_match_jax(scenes, jax_maps):
    """`render_frame` with the raster primary, sun cascades (JAX's, carried
    over), half-res AO and SSR with temporal accumulation, TAA, bloom,
    tonemap and sharpen at 128^2: frame 1 from the initial state, frame 2
    from the port's own carried state and again from JAX's state carried
    over (`frame_state_from_numpy`).  At least 99% of `ldr` pixels within
    1e-3 and the mean error below 1e-4, each time."""
    js, ts, cam = scenes
    keys = [jax.random.PRNGKey(3), jax.random.PRNGKey(4)]
    want = _jax_frames(scenes, jax_maps, jpipe.RendererSettings(
        primary="raster", half_res_effects=True), keys)
    settings = tpipe.RendererSettings(primary="raster", half_res_effects=True)
    maps = convert.sun_shadow_maps_from_numpy(jax_maps, "cpu")
    tc = convert.camera_from_numpy(cam, "cpu")
    state = tpipe.initial_frame_state(W, H, "cpu")
    for i, k in enumerate(keys):
        ldr, state, aux = tpipe.render_frame(
            ts, tc, W, H, settings, shadow_maps=maps, frame_state=state,
            prev_camera=tc, jitter=torch.as_tensor(_jitter(k)))
        assert ldr.shape == (H, W, 3) and bool(torch.isfinite(ldr).all())
        _compare_frames(ldr, want[i][0])
        assert int(state.frame_index) == i + 1
        assert int(aux["gbuffer"].overflow) == 0
    jstate = convert.frame_state_from_numpy(want[0][1], "cpu")
    ldr, _, _ = tpipe.render_frame(ts, tc, W, H, settings, shadow_maps=maps,
                                   frame_state=jstate, prev_camera=tc,
                                   jitter=torch.as_tensor(_jitter(keys[1])))
    _compare_frames(ldr, want[1][0])


def test_raster_frame_matches_ray_frame_on_the_port(scenes):
    """The pipeline-level parity the JAX package lacks: the same frame with
    `primary="raster"` and with `primary="ray"` under one per-frame offset
    (rays through pixel + jitter).  The two G-buffers differ only at edge
    pixels and in t's last bits, so 99% of `ldr` pixels agree within 1e-3
    and the mean error is below 1e-4."""
    _, ts, cam = scenes
    tc = convert.camera_from_numpy(cam, "cpu")
    jit = torch.tensor([0.3, 0.7])

    class OneOffset:
        def uniform(self, shape):
            return jit.expand(shape).clone()

    maps = tshadows.render_sun_shadow_maps(
        ts.bvh, tshadows.fit_cascades(tc.position, -ts.sky.sun_direction),
        resolution=64)
    frames = {}
    for primary in ("raster", "ray"):
        settings = tpipe.RendererSettings(primary=primary,
                                          half_res_effects=True)
        frames[primary], _, _ = tpipe.render_frame(
            ts, tc, W, H, settings, shadow_maps=maps, jitter=jit,
            sampler=OneOffset())
    _compare_frames(frames["raster"], frames["ray"].numpy())


def _jax_options(js, cam):
    """Every option of `render_frame`, made on the JAX side: two point
    lights (the first with a 2 x 48^2 map), a spot light with its 64^2
    map, a 3 x 2 x 3 probe grid updated twice, a decal, a glass slab and
    water at y = 0.3."""
    from d3d12renderer_tpu.render import decals as jdecals
    from d3d12renderer_tpu.render import light_probe as jprobe
    from d3d12renderer_tpu.render import lights as jlights
    from d3d12renderer_tpu.render import transparent as jtransparent

    spot_pos, spot_dir = (3.0, 5.0, 3.0), np.array([-0.5, -0.85, -0.4])
    spot_dir = spot_dir / np.linalg.norm(spot_dir)
    grid = jprobe.create_probe_grid((-6.0, 0.5, -6.0), (12.0, 4.0, 12.0),
                                    (3, 2, 3))
    for i in range(2):
        grid = jprobe.update_probes(grid, js, jax.random.PRNGKey(40 + i),
                                    rays_per_probe=16)
    glass = jtransparent.TransparentObject(
        bvh=jbvh.build_bvh([(jmesh.box((1.2, 1.0, 0.08)).transformed(
            translate=(2.8, 1.1, 2.6)), 0)], cache=False),
        color=(0.5, 0.8, 0.7), alpha=0.35)
    return {
        "point_lights": jlights.make_point_lights(
            [[2.5, 2.0, 2.5], [-3.0, 1.5, -1.0]],
            [[8.0, 6.0, 4.0], [4.0, 6.0, 8.0]], [6.0, 6.0]),
        "spot_lights": jlights.SpotLights(
            position=jnp.array([spot_pos]),
            direction=jnp.asarray(spot_dir[None], jnp.float32),
            color=jnp.array([[45.0, 42.0, 38.0]]),
            distance=jnp.array([28.0]), inner_cos=jnp.array([0.85]),
            outer_cos=jnp.array([0.65]), valid=jnp.array([True])),
        "spot_shadow_maps": [jshadows.render_spot_shadow_map(
            js.bvh, spot_pos, spot_dir, 0.65, 28.0, resolution=64)],
        "point_shadow_maps": [jshadows.render_point_shadow_map(
            js.bvh, (2.5, 2.0, 2.5), 6.0, resolution=48), None],
        "probe_grid": grid,
        "decals": jdecals.make_decals(
            positions=[(1.0, 0.0, 2.0)], rotations=[(0.7071, 0.0, 0.0, 0.7071)],
            half_extents=[(1.2, 1.2, 2.0)], albedos=[(0.05, 0.05, 0.06)]),
        "transparent_objects": [glass],
        "water_height": 0.3,
    }


def _port_options(jopts):
    out = {}
    for k, v in jopts.items():
        if k in ("point_lights",):
            out[k] = convert.point_lights_from_numpy(v, "cpu")
        elif k == "spot_lights":
            out[k] = convert.spot_lights_from_numpy(v, "cpu")
        elif k == "spot_shadow_maps":
            out[k] = [convert.spot_shadow_map_from_numpy(x, "cpu") for x in v]
        elif k == "point_shadow_maps":
            out[k] = [None if x is None else
                      convert.point_shadow_map_from_numpy(x, "cpu") for x in v]
        elif k == "probe_grid":
            out[k] = convert.light_probe_grid_from_numpy(v, "cpu")
        elif k == "decals":
            out[k] = convert.decals_from_numpy(v, "cpu")
        elif k == "transparent_objects":
            out[k] = [convert.transparent_object_from_numpy(x, "cpu")
                      for x in v]
        else:
            out[k] = v
    return out


@pytest.fixture(scope="module")
def options(scenes):
    js, _, cam = scenes
    jopts = _jax_options(js, cam)
    return jopts, _port_options(jopts)


# Each option alone (the spot light with its map; point lights without
# maps take the Forward+ tile lists), then all of them together (the point
# light with its map, so the per-light shadowed path).
FRAME_OPTIONS = ("enable_sss", "enable_rt_reflections", "point_lights",
                 "spot_lights", "probe_grid", "decals",
                 "transparent_objects", "water_height", "all")


def _option_kwargs(option, opts):
    if option.startswith("enable_"):
        return {option: True}, {}
    if option == "spot_lights":
        return {}, {k: opts[k] for k in ("spot_lights", "spot_shadow_maps")}
    if option == "all":
        return ({"enable_sss": True, "enable_rt_reflections": True},
                dict(opts))
    return {}, {option: opts[option]}


@pytest.mark.parametrize("option", FRAME_OPTIONS)
def test_frame_option_matches_jax(scenes, jax_maps, options, option):
    """Two frames of `render_frame` (raster primary, half-res effects, JAX's
    cascades carried over) with one option, or all of them, against JAX's
    frames under `jax.jit` from the same state and jitter: each frame's
    `ldr` within PIXEL_TOL on SHARE of the pixels, the mean error below
    MEAN_TOL; the option changes the frame (against the frame without it,
    beyond PIXEL_TOL on at least 0.5% of the pixels)."""
    js, ts, cam = scenes
    jopts, topts = options
    flags, jkw = _option_kwargs(option, jopts)
    _, tkw = _option_kwargs(option, topts)
    jset = jpipe.RendererSettings(primary="raster", half_res_effects=True,
                                  **flags)
    keys = [jax.random.PRNGKey(3), jax.random.PRNGKey(4)]
    fn = jax.jit(lambda st, k: jpipe.render_frame(
        js, cam, W, H, jset, shadow_maps=jax_maps, frame_state=st,
        prev_camera=cam, key=k, **jkw)[:2])
    st, want = jpipe.initial_frame_state(W, H), []
    for k in keys:
        ldr, st = fn(st, k)
        want.append(np.asarray(ldr))

    settings = tpipe.RendererSettings(primary="raster", half_res_effects=True,
                                      **flags)
    maps = convert.sun_shadow_maps_from_numpy(jax_maps, "cpu")
    tc = convert.camera_from_numpy(cam, "cpu")
    state = tpipe.initial_frame_state(W, H, "cpu")
    plain = tpipe.render_frame(
        ts, tc, W, H, tpipe.RendererSettings(primary="raster",
                                             half_res_effects=True),
        shadow_maps=maps, frame_state=state, prev_camera=tc,
        jitter=torch.as_tensor(_jitter(keys[0])))[0]
    for i, k in enumerate(keys):
        ldr, state, aux = tpipe.render_frame(
            ts, tc, W, H, settings, shadow_maps=maps, frame_state=state,
            prev_camera=tc, jitter=torch.as_tensor(_jitter(k)), **tkw)
        assert ldr.shape == (H, W, 3) and bool(torch.isfinite(ldr).all())
        _compare_frames(ldr, want[i])
        if i == 0:
            changed = (np.abs(_np(ldr) - _np(plain)).max(-1) > PIXEL_TOL)
            assert changed.mean() > 5e-3, changed.mean()
    assert int(state.frame_index) == 2


@pytest.fixture(scope="module")
def gbuffers(scenes):
    """JAX's G-buffer of the test scene at W x H (rays through pixel
    centres) and the same buffer carried over to the port."""
    from d3d12renderer_tpu_torch.render.gbuffer import GBuffer

    js, _, cam = scenes
    jgb = j_gbuffer(js, cam, W, H)
    tgb = GBuffer(**{f: torch.as_tensor(np.array(getattr(jgb, f)))
                     for f in GBuffer.__dataclass_fields__
                     if f not in ("overflow", "pairs")})
    return jgb, tgb


def _share_close(got, want, tol=PIXEL_TOL, share=SHARE):
    """Per pixel (last axis the channels): within `tol` on `share` of the
    pixels (a flipped hit changes a pixel by much more)."""
    err = np.abs(_np(got) - np.asarray(want))
    err = err.max(-1) if err.ndim == 3 else err
    assert (err <= tol).mean() >= share, (err <= tol).mean()


def test_rt_reflections_match_jax(scenes, gbuffers):
    """Mirror rays from the G-buffer through `closest_hit` and `any_hit`:
    the mask equal, the radiance per pixel (a mirror ray that grazes an
    edge may hit the other triangle)."""
    from d3d12renderer_tpu_torch.render.pipeline import rt_reflections

    js, ts, cam = scenes
    jgb, tgb = gbuffers
    want, wmask = jpipe.rt_reflections(js, jgb, cam)
    got, mask = rt_reflections(ts, tgb, convert.camera_from_numpy(cam, "cpu"))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))
    assert 0.05 < mask.numpy().mean() < 0.9
    _share_close(got, want)
    assert np.abs(np.asarray(want)).max() > 0.01


def test_decals_match_jax(gbuffers):
    """Two decals (one straight down, one tilted, strengths 1 and 0.6)
    blended into the G-buffer's albedo, roughness and metallic within
    1e-6; some pixels inside each."""
    from d3d12renderer_tpu.render import decals as jdecals
    from d3d12renderer_tpu_torch.render import decals as tdecals

    jgb, tgb = gbuffers
    kw = dict(positions=[(1.0, 0.0, 2.0), (0.3, 1.2, 0.9)],
              rotations=[(0.7071, 0.0, 0.0, 0.7071),
                         (0.3, 0.1, 0.0, 0.9487)],
              half_extents=[(1.2, 1.2, 2.0), (0.6, 0.5, 0.8)],
              albedos=[(0.05, 0.05, 0.06), (0.9, 0.7, 0.1)],
              roughness=[0.5, 0.2], metallic=[0.0, 1.0], strength=[1.0, 0.6])
    want = jdecals.apply_decals(jgb, jdecals.make_decals(**kw))
    got = tdecals.apply_decals(tgb, tdecals.make_decals(**kw, device="cpu"))
    for f in ("albedo", "roughness", "metallic"):
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   np.asarray(getattr(want, f)), atol=1e-6,
                                   err_msg=f)
    changed = np.abs(_np(got.albedo) - _np(tgb.albedo)).max(-1) > 1e-3
    assert changed.mean() > 0.01
    assert torch.equal(tgb.albedo, torch.as_tensor(np.array(jgb.albedo)))


def test_decal_tile_lists_match_jax(scenes, gbuffers):
    from d3d12renderer_tpu.render import decals as jdecals
    from d3d12renderer_tpu_torch.render import decals as tdecals

    _, _, cam = scenes
    jgb, tgb = gbuffers
    rng = np.random.default_rng(9)
    kw = dict(positions=rng.uniform(-2, 2, (48, 3)),
              rotations=[(0.0, 0.0, 0.0, 1.0)] * 48,
              half_extents=rng.uniform(0.5, 2.5, (48, 3)),
              albedos=rng.uniform(0, 1, (48, 3)))
    want = jdecals.cull_decals_tiled(jgb.view_pos, jdecals.make_decals(**kw),
                                     cam, W, H)
    got = tdecals.cull_decals_tiled(tgb.view_pos,
                                    tdecals.make_decals(**kw, device="cpu"),
                                    convert.camera_from_numpy(cam, "cpu"),
                                    W, H)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    assert (_np(got[1]) > 16).any()


def test_transparent_pass_matches_jax(scenes, gbuffers):
    """Two glass slabs, one behind the other in part, over a random colour
    buffer: each through `closest_hit` on its own 12-row table (the
    brute-force ray kernel's table size), depth-tested against the
    G-buffer, blended back to front; per pixel within PIXEL_TOL."""
    from d3d12renderer_tpu.render import transparent as jtransparent
    from d3d12renderer_tpu_torch.render import transparent as ttransparent

    js, ts, cam = scenes
    jgb, tgb = gbuffers
    objs = []
    for at, color, alpha in (((2.8, 1.1, 2.6), (0.5, 0.8, 0.7), 0.35),
                             ((1.8, 1.0, 1.6), (0.9, 0.4, 0.3), 0.5)):
        objs.append(jtransparent.TransparentObject(
            bvh=jbvh.build_bvh([(jmesh.box((1.2, 1.0, 0.08)).transformed(
                translate=at), 0)], cache=False), color=color, alpha=alpha))
    color = np.random.default_rng(3).random((H, W, 3)).astype(np.float32)
    want = jtransparent.transparent_pass(jnp.asarray(color), jgb, cam, objs,
                                         sky=js.sky)
    tobjs = [convert.transparent_object_from_numpy(o, "cpu") for o in objs]
    assert all(o.bvh.dense.n.shape[0] == 12 for o in tobjs)
    got = ttransparent.transparent_pass(
        torch.as_tensor(color), tgb, convert.camera_from_numpy(cam, "cpu"),
        tobjs, sky=ts.sky)
    _share_close(got, want)
    covered = np.abs(_np(got) - color).max(-1) > 1e-3
    assert 0.01 < covered.mean() < 0.9


def test_water_pass_matches_jax(scenes, gbuffers):
    """The water plane at y = 0.3 and time 0.7 over a random colour
    buffer: per pixel within PIXEL_TOL (a refraction offset that rounds the
    other way samples another pixel)."""
    from d3d12renderer_tpu.render.water_pass import water_pass as jwater
    from d3d12renderer_tpu_torch.render.water_pass import water_pass

    js, ts, cam = scenes
    jgb, tgb = gbuffers
    color = np.random.default_rng(4).random((H, W, 3)).astype(np.float32)
    want = jwater(jnp.asarray(color), jgb, cam, js.sky, water_height=0.3,
                  time=0.7)
    got = water_pass(torch.as_tensor(color), tgb,
                     convert.camera_from_numpy(cam, "cpu"), ts.sky,
                     water_height=0.3, time=0.7)
    _share_close(got, want)
    covered = np.abs(_np(got) - color).max(-1) > 1e-3
    assert 0.1 < covered.mean() < 0.95


def test_water_normal_and_color_match_jax():
    from d3d12renderer_tpu.terrain import water as jw
    from d3d12renderer_tpu_torch.terrain import water as tw

    rng = np.random.default_rng(2)
    x, z = rng.uniform(-20, 20, (2, 500)).astype(np.float32)
    for t in (0.0, 1.3):
        np.testing.assert_allclose(
            _np(tw.water_normal(torch.as_tensor(x), torch.as_tensor(z), t)),
            np.asarray(jw.water_normal(jnp.asarray(x), jnp.asarray(z), t)),
            atol=1e-6)
    depth = rng.uniform(0, 5, 200).astype(np.float32)
    np.testing.assert_allclose(_np(tw.water_color(torch.as_tensor(depth))),
                               np.asarray(jw.water_color(jnp.asarray(depth))),
                               atol=1e-7)


@pytest.fixture(scope="module")
def small_scenes():
    """The test scene with a 80-triangle sphere (one table chunk: the
    cascade view casts its 3 x 256^2 shadow rays through the plain
    version here)."""
    def meshes(mm):
        return [(mm.quad(half=20.0), 0),
                (mm.ico_sphere(1.0, 1).transformed(translate=(0, 1.0, 0)), 1),
                (mm.box((0.7, 0.7, 0.7)).transformed(
                    translate=(2.2, 0.7, -0.5)), 2)]

    bvh = jbvh.build_bvh(meshes(jmesh), cache=False)
    mats = jpt.Materials(**{k: jnp.asarray(v) for k, v in MATERIALS.items()})
    js = jpt.Scene(bvh=bvh, materials=mats,
                   sky=jpt.default_sky()).with_shading_table()
    ts = tpt.Scene(bvh=convert.bvh_from_numpy(bvh, "cpu"),
                   materials=convert.materials_from_numpy(mats, "cpu"),
                   sky=convert.sky_from_numpy(js.sky, "cpu")).with_shading_table()
    assert ts.bvh.dense.n.shape[0] <= 1024
    return js, ts


@pytest.mark.parametrize("mode", ["rasterized", "path_traced",
                                  "visualize_cascades"])
def test_render_mode_matches_jax(scenes, small_scenes, mode, monkeypatch):
    """The three modes at 48x32 on the small scene: rasterized (raster
    primary, 64^2 cascades, JAX's jitter
    from its key) and the cascade view against JAX's frames under `jax.jit`
    pixel by pixel;
    the path-traced mode at 1 spp with JAX's draws recorded under
    `jax.disable_jit()` and replayed (the path tracer's criterion, >= 99%
    of pixels within 1e-3)."""
    from d3d12renderer_tpu.render.pathtracer import PathTracerSettings

    from tests.test_torch_pathtracer import ReplaySampler

    _, _, cam = scenes
    js, ts = small_scenes
    w, h = 48, 32
    jc = cam.replace(aspect=w / h)
    tc = convert.camera_from_numpy(jc, "cpu")
    key = jax.random.PRNGKey(6)
    if mode == "rasterized":
        want = jax.jit(lambda k: jpipe.render_mode(
            js, jc, w, h, mode, key=k, shadow_resolution=64,
            settings=jpipe.RendererSettings(primary="raster")))(key)
        got = tpipe.render_mode(ts, tc, w, h, mode,
                                settings=tpipe.RendererSettings(
                                    primary="raster"),
                                shadow_resolution=64,
                                jitter=torch.as_tensor(_jitter(key)))
    elif mode == "path_traced":
        draws = []
        for kind in ("uniform", "normal", "randint"):
            orig = getattr(jax.random, kind)

            def record(*a, _orig=orig, _kind=kind, **k):
                x = _orig(*a, **k)
                draws.append((_kind, np.asarray(x)))
                return x
            monkeypatch.setattr(jax.random, kind, record)
        with jax.disable_jit():
            want = jpipe.render_mode(js, jc, w, h, mode, spp=1, key=key,
                                     settings=PathTracerSettings(
                                         recursion_depth=2))
        monkeypatch.undo()
        sampler = ReplaySampler(draws)
        got = tpipe.render_mode(ts, tc, w, h, mode, spp=1, sampler=sampler,
                                settings=tpt.PathTracerSettings(
                                    recursion_depth=2))
        assert not sampler.draws
    else:
        want = jax.jit(lambda: jpipe.render_mode(js, jc, w, h, mode))()
        got = tpipe.render_mode(ts, tc, w, h, mode)
    assert got.shape == (h, w, 3) and bool(torch.isfinite(got).all())
    assert 0.02 < float(got.mean()) < 0.98
    _share_close(got, want)
    with pytest.raises(ValueError, match="unknown renderer mode"):
        tpipe.render_mode(ts, tc, w, h, "wireframe")


def test_raster_entry_on_cpu(monkeypatch):
    """The main path's set-up and frames on the CPU at a tiny ragged size
    (80x36: both padded to the 64x32 tiles and cropped back), with
    the atrium swapped for this file's scene (the atrium's 250k visible
    triangles take the plain rasterizer ~40 s per frame here): frames
    carry state, draw their jitter from the seeded generator (the same seed
    gives the same frames), and launch no kernel on the CPU."""
    from d3d12renderer_tpu_torch.render import mesh as tmesh

    monkeypatch.setattr(entry, "RASTER_SHADOW_RESOLUTION", 16)
    monkeypatch.setattr(tmesh, "atrium_scene",
                        lambda scale: [(m, i % 6) for m, i in _meshes(tmesh)])
    before = (image.gaussian_blur.launches, image.tonemap.launches,
              raster.rasterize_tiles.launches)
    frames = []
    for _ in range(2):
        fn, state = entry.raster_entry(device="cpu", width=80, height=36,
                                       seed=3)
        ldr, state, aux = fn(state)
        ldr2, state, aux2 = fn(state)
        frames.append(ldr2)
    assert ldr.shape == (36, 80, 3) and bool(torch.isfinite(ldr2).all())
    assert not torch.equal(ldr, ldr2)              # another jitter, history
    assert torch.equal(frames[0], frames[1])
    assert int(state.frame_index) == 2
    assert int(aux2["gbuffer"].overflow) == 0 and aux2["gbuffer"].pairs > 0
    assert 0.0 < float(ldr2.mean()) < 1.0
    assert (image.gaussian_blur.launches, image.tonemap.launches,
            raster.rasterize_tiles.launches) == before


def _small_atrium(monkeypatch):
    """The entries' atrium swapped for this file's scene, and their shadow
    maps cut to 16^2 (as `test_raster_entry_on_cpu`)."""
    from d3d12renderer_tpu_torch.render import mesh as tmesh

    monkeypatch.setattr(entry, "RASTER_SHADOW_RESOLUTION", 16)
    monkeypatch.setattr(entry, "SHOWCASE_SPOT_RESOLUTION", 16)
    monkeypatch.setattr(entry, "SHOWCASE_POINT_RESOLUTION", 16)
    monkeypatch.setattr(entry, "SHOWCASE_ATLAS_SIZE", 128)
    monkeypatch.setattr(tmesh, "atrium_scene",
                        lambda scale: [(m, i % 6) for m, i in _meshes(tmesh)])


@pytest.mark.parametrize("name", ["raster_showcase_entry",
                                  "raster_lights_entry"])
def test_new_raster_entries_on_cpu(monkeypatch, name):
    """The showcase and Forward+ entries at 80x36 on the CPU with the
    atrium swapped for this file's scene: two frames carry state, are
    finite and launch no kernel; an option given per frame replaces the
    entry's (without the entry's lights the frame differs); the showcase's
    atlas holds its 5 viewports, each rendered once."""
    _small_atrium(monkeypatch)
    before = (image.gaussian_blur.launches, image.tonemap.launches,
              raster.rasterize_tiles.launches)
    fn, state = getattr(entry, name)(device="cpu", width=80, height=36,
                                     seed=2)
    ldr, state, aux = fn(state)
    jitter = torch.tensor([0.25, 0.75])
    ldr2, state2, aux2 = fn(state, jitter=jitter)
    assert ldr2.shape == (36, 80, 3) and bool(torch.isfinite(ldr2).all())
    assert int(state2.frame_index) == 2 and not torch.equal(ldr, ldr2)
    unlit, _, _ = fn(state, jitter=jitter, point_lights=None)
    assert not torch.equal(unlit, ldr2)
    assert (image.gaussian_blur.launches, image.tonemap.launches,
            raster.rasterize_tiles.launches) == before
    if name == "raster_showcase_entry":
        assert fn.options["settings"].enable_sss
        assert fn.options["settings"].enable_rt_reflections
        assert "rt_reflections" in aux2
        assert len(fn.atlas.viewports) == 5
        assert (fn.atlas.cache.misses, fn.atlas.cache.hits) == (5, 0)
        assert float(fn.options["probe_grid"].irradiance.abs().max()) > 0
    else:
        assert fn.options["point_lights"].position.shape == (
            entry.RASTER_LIGHTS, 3)
