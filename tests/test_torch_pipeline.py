"""The port's raster frame (`render/pipeline.py` and the G-buffer, shadow
and camera modules under it) against the JAX package on the CPU, two whole
frames with carried state included; the raster primary against the ray
primary on the port; the options that are not ported yet; and the main
path's entry at a tiny size.  Jitter is computed on the JAX side
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


@pytest.mark.parametrize("option", [
    "enable_sss", "enable_rt_reflections", "point_lights", "spot_lights",
    "probe_grid", "decals", "transparent_objects", "water_height"])
def test_unported_options_raise(scenes, option):
    _, ts, cam = scenes
    settings, kw = tpipe.RendererSettings(primary="raster"), {}
    if option.startswith("enable_"):
        settings = tpipe.RendererSettings(primary="raster", **{option: True})
    else:
        kw[option] = [object()] if option == "transparent_objects" else object()
    with pytest.raises(NotImplementedError, match=option):
        tpipe.render_frame(ts, convert.camera_from_numpy(cam, "cpu"), 16, 16,
                           settings, **kw)


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
