"""The rasterized frame (counterpart of ``d3d12renderer_tpu/render/pipeline.py``
`render_frame`, one dispatch), and the renderer's three modes.

Stages, in order: G-buffer (raster or ray primary visibility; decals
projected into it) -> effects (sun shadow term from the cascades, HBAO,
screen-space shadows; half-res with temporal accumulation and a bilateral
upsample when `half_res_effects`) -> opaque (sun BRDF, probe-grid or
sky-tinted ambient, emissive, point lights either shadowed per light or
through the Forward+ tile lists, spot lights with their maps) ->
reflections (SSR, ray-traced reflections filling where SSR found
nothing) -> compose (sky where nothing was hit, transparents, water) ->
TAA -> post (bloom, tonemap, sharpen).  The JAX package's per-pass /
grouped / fused dispatch modes give identical frames and exist for its
TPU compiler; here the stages simply run in turn.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional

import torch

from ..core import maths as m
from ..core import profiling
from . import bvh as bvh_mod
from . import post
from .camera import Camera
from .gbuffer import GBuffer, render_gbuffer
from .lights import (cull_lights_tiled, eval_brdf_pixel, shade_point_lights,
                     shade_point_lights_shadowed, shade_spot_lights)
from .pathtracer import Scene, sample_albedo, sky_radiance
from .shadows import (SunShadowMaps, fit_cascades, render_sun_shadow_maps,
                      sample_sun_shadow)


@dataclass(frozen=True)
class RendererSettings:
    """Live-tunable settings (reference: renderer_settings,
    main_renderer.h:28-64)."""

    # Primary visibility: "ray" (BVH primary rays) or "raster" (the tile
    # rasterizer, ops/raster.py).
    primary: str = "ray"
    enable_ao: bool = True
    enable_sss: bool = False
    enable_ssr: bool = True
    enable_taa: bool = True
    enable_bloom: bool = True
    enable_sharpen: bool = True
    enable_shadows: bool = True
    enable_rt_reflections: bool = False
    # AO, SSS and SSR at half resolution with temporal accumulation and a
    # bilateral depth-aware upsample (the reference's default).
    half_res_effects: bool = False
    hbao: post.HBAOSettings = post.HBAOSettings()
    sss: post.SSSSettings = post.SSSSettings()
    ssr: post.SSRSettings = post.SSRSettings()
    taa: post.TAASettings = post.TAASettings()
    bloom: post.BloomSettings = post.BloomSettings(threshold=3.0, strength=0.3)
    sharpen: post.SharpenSettings = post.SharpenSettings()
    tonemap: post.TonemapSettings = post.TonemapSettings()
    ambient_strength: float = 0.35


@dataclass
class FrameState:
    """Temporal resources carried between frames: the TAA history and the
    half-res AO / SSS / SSR accumulation buffers."""

    history: torch.Tensor                 # (H, W, 3) TAA history (pre-tonemap)
    frame_index: torch.Tensor             # () int32
    ao_history: Optional[torch.Tensor] = None        # (H/2, W/2)
    sss_history: Optional[torch.Tensor] = None       # (H/2, W/2)
    ssr_history: Optional[torch.Tensor] = None       # (H/2, W/2, 3)
    ssr_conf_history: Optional[torch.Tensor] = None  # (H/2, W/2)


def initial_frame_state(width: int, height: int, device="cuda") -> FrameState:
    from ..cuda_build import resolve_device

    device = resolve_device(device)
    h2, w2 = height // 2, width // 2
    return FrameState(
        history=torch.zeros((height, width, 3), device=device),
        frame_index=torch.zeros((), dtype=torch.int32, device=device),
        ao_history=torch.ones((h2, w2), device=device),
        sss_history=torch.ones((h2, w2), device=device),
        ssr_history=torch.zeros((h2, w2, 3), device=device),
        ssr_conf_history=torch.zeros((h2, w2), device=device))


@dataclass
class _HalfRes:
    """The half-res effects' inputs, shared by AO, SSS and SSR."""

    view_pos: torch.Tensor
    normal: torch.Tensor
    depth_full: torch.Tensor
    depth_low: torch.Tensor
    motion: torch.Tensor
    first: Optional[torch.Tensor]

    @staticmethod
    def of(gb: GBuffer, frame_state: Optional[FrameState]) -> "_HalfRes":
        vp_low = post.downsample2(gb.view_pos)
        return _HalfRes(
            view_pos=vp_low, normal=m.noz(post.downsample2(gb.view_normal)),
            depth_full=torch.abs(gb.view_pos[..., 2]),
            depth_low=torch.abs(vp_low[..., 2]),
            motion=post.downsample2(gb.motion) * 0.5,
            first=None if frame_state is None else frame_state.frame_index == 0)


def rt_reflections(scene: Scene, gb: GBuffer, camera: Camera,
                   max_roughness: float = 0.6):
    """One-bounce ray-traced specular reflections: a mirror ray from every
    pixel's hit (one closest-hit query), its hit shaded with the sun (one
    any-hit query for the shadow) and the sky's hemisphere; the sky where
    it escapes.  Returns (radiance (H, W, 3), mask (H, W)): zero and False
    off the surfaces rougher than `max_roughness` and on the sky."""
    h, w = gb.depth.shape
    v = m.noz(camera.position - gb.world_pos)
    n = gb.normal
    d = m.noz(2.0 * torch.sum(n * v, -1, keepdim=True) * n - v)
    o = gb.world_pos + n * 1e-3
    active = gb.hit & (gb.roughness < max_roughness)
    o_f, d_f = o.reshape(-1, 3), d.reshape(-1, 3)
    res = bvh_mod.closest_hit(scene.bvh, o_f, d_f)
    hn, _, huv, hmat = bvh_mod.hit_attributes(scene.bvh, res)
    hp = o_f + d_f * res["t"][:, None]
    albedo = sample_albedo(scene.materials, hmat, huv)
    to_sun = m.noz(scene.sky.sun_direction)
    ndl = torch.clamp(torch.sum(hn * to_sun, -1), min=0.0)
    shadowed = bvh_mod.any_hit(scene.bvh, hp + hn * 1e-3,
                               to_sun.expand(hp.shape), 1e4)
    sun = ((scene.sky.sun_radiance * 0.05) * ndl[:, None]
           * (~shadowed)[:, None] / math.pi)
    up = torch.clamp(hn[:, 1:2] * 0.5 + 0.5, 0.0, 1.0)
    ambient = scene.sky.horizon * (1 - up) + scene.sky.zenith * up
    lit = albedo * (sun + ambient * 0.35) + scene.materials.emissive[hmat]
    sky = sky_radiance(scene.sky, d_f)
    radiance = torch.where(res["hit"][:, None], lit, sky).reshape(h, w, 3)
    return torch.where(active[..., None], radiance, 0.0), active


def _half_res_effect(low, half, frame_state, updates, name):
    """Accumulate a half-res effect against its history `frame_state.<name>`
    (the result recorded in `updates[name]`) and upsample it to full
    resolution."""
    history = None if frame_state is None else getattr(frame_state, name)
    if history is not None:
        low = post.temporal_accumulate(low, history, half.motion,
                                       first=half.first)
        updates[name] = low
    return post.bilateral_upsample(low, half.depth_low, half.depth_full)


def _effects(scene, camera, gb, shadow_maps, frame_state, half, settings,
             width, height):
    """Sun shadow term (times the screen-space shadows) and AO; history
    updates for the half-res path."""
    dev = gb.depth.device
    updates = {}
    if settings.enable_shadows and shadow_maps is not None:
        lit, _ = sample_sun_shadow(shadow_maps, gb.world_pos)
    else:
        lit = torch.ones((height, width), device=dev)
    if not settings.enable_ao:
        ao = torch.ones((height, width), device=dev)
    elif half is None:
        ao = post.hbao(gb.view_pos, gb.view_normal, settings.hbao)
    else:
        ao = _half_res_effect(post.hbao(half.view_pos, half.normal,
                                        settings.hbao),
                              half, frame_state, updates, "ao_history")
    if settings.enable_sss:
        sun_view = m.quat_inv_rotate(camera.rotation, scene.sky.sun_direction)
        if half is None:
            sss = post.screen_space_shadows(gb.view_pos, sun_view, gb.depth,
                                            settings.sss)
        else:
            sss = _half_res_effect(
                post.screen_space_shadows(half.view_pos, sun_view,
                                          half.depth_low, settings.sss),
                half, frame_state, updates, "sss_history")
        lit = lit * sss
    return lit, ao, updates


def _opaque(scene, camera, gb, lit, ao, settings, width, height,
            point_lights, point_shadow_maps, spot_lights, spot_shadow_maps,
            probe_grid):
    sun_l = scene.sky.sun_direction
    v = m.noz(camera.position - gb.world_pos)
    f_sun = eval_brdf_pixel(gb.normal, v, sun_l.expand(gb.normal.shape),
                            gb.albedo, gb.roughness, gb.metallic)
    color = f_sun * (scene.sky.sun_radiance * 0.05) * lit[..., None]
    if probe_grid is not None:
        from .light_probe import sample_irradiance

        ambient = sample_irradiance(probe_grid, gb.world_pos, gb.normal)
    else:
        up = torch.clamp(gb.normal[..., 1:2] * 0.5 + 0.5, 0.0, 1.0)
        ambient = scene.sky.horizon * (1 - up) + scene.sky.zenith * up
    color = color + gb.albedo * ambient * settings.ambient_strength * ao[..., None]
    color = color + gb.emissive
    if point_lights is not None:
        if point_shadow_maps is not None:
            color = color + shade_point_lights_shadowed(
                gb, point_lights, camera, point_shadow_maps)
        else:
            tile_lists, _ = cull_lights_tiled(gb.view_pos, point_lights,
                                              camera, width, height)
            color = color + shade_point_lights(gb, point_lights, tile_lists,
                                               camera)
    if spot_lights is not None:
        color = color + shade_spot_lights(gb, spot_lights, camera,
                                          shadow_maps=spot_shadow_maps)
    return color, ambient


def _reflections(scene, camera, color, gb, frame_state, half, settings):
    """SSR resolve, ray-traced reflections filling where SSR's confidence
    falls short; (color, RT radiance or None, SSR confidence (H, W) or
    None, history updates)."""
    updates = {}
    rt_refl = None
    if settings.enable_rt_reflections:
        rt_refl, rt_mask = rt_reflections(scene, gb, camera)
    if not settings.enable_ssr and rt_refl is None:
        return color, None, None, updates
    f0 = 0.04 * (1 - gb.metallic[..., None]) + gb.albedo * gb.metallic[..., None]
    tan_half = math.tan(camera.v_fov * 0.5)
    if not settings.enable_ssr:
        refl = torch.zeros_like(color)
        conf = torch.zeros(color.shape[:-1], device=color.device)
    elif half is None:
        refl, conf = post.ssr(color, gb.view_pos, gb.view_normal, gb.roughness,
                              settings.ssr, tan_half=tan_half,
                              aspect=camera.aspect)
    else:
        refl, conf = post.ssr(post.downsample2(color), half.view_pos,
                              half.normal, post.downsample2(gb.roughness),
                              settings.ssr, tan_half=tan_half,
                              aspect=camera.aspect)
        if frame_state is not None and frame_state.ssr_history is not None:
            refl = post.temporal_accumulate(refl, frame_state.ssr_history,
                                            half.motion, first=half.first)
            conf = post.temporal_accumulate(conf, frame_state.ssr_conf_history,
                                            half.motion, first=half.first)
            updates.update(ssr_history=refl, ssr_conf_history=conf)
        refl = post.bilateral_upsample(refl, half.depth_low, half.depth_full)
        conf = post.bilateral_upsample(conf, half.depth_low, half.depth_full)
    if rt_refl is not None:
        refl = (refl * conf[..., None]
                + rt_refl * (1.0 - conf[..., None]) * rt_mask[..., None])
        return color + refl * f0, rt_refl, conf, updates
    return color + refl * conf[..., None] * f0, None, conf, updates


def _compose(scene, camera, color, gb, width, height, transparent_objects,
             water_height, time_s):
    d = m.noz(gb.world_pos - camera.position)
    sky = sky_radiance(scene.sky, d.reshape(-1, 3)).reshape(height, width, 3)
    color = torch.where(gb.hit[..., None], color, sky)
    if transparent_objects:
        from .transparent import transparent_pass

        color = transparent_pass(color, gb, camera, transparent_objects,
                                 sky=scene.sky)
    if water_height is not None:
        from .water_pass import water_pass

        color = water_pass(color, gb, camera, scene.sky,
                           water_height=water_height, time=time_s)
    return color


def _taa(color, gb, frame_state, updates, settings):
    if frame_state is None:
        return color, None
    if settings.enable_taa:
        blended = post.taa(color, frame_state.history, gb.motion, settings.taa)
        color = torch.where(frame_state.frame_index == 0, color, blended)
    return color, replace(frame_state, history=color,
                          frame_index=frame_state.frame_index + 1, **updates)


def _post(color, settings):
    if settings.enable_bloom:
        color = post.bloom(color, settings.bloom)
    ldr = post.tonemap_uncharted2(color, settings.tonemap)
    if settings.enable_sharpen:
        ldr = post.sharpen(ldr, settings.sharpen)
    return ldr


def render_frame(scene: Scene, camera: Camera, width: int, height: int,
                 settings: RendererSettings = RendererSettings(),
                 shadow_maps: Optional[SunShadowMaps] = None,
                 frame_state: Optional[FrameState] = None,
                 prev_camera: Optional[Camera] = None, jitter=None,
                 sampler=None, point_lights=None, spot_lights=None,
                 spot_shadow_maps=None, point_shadow_maps=None,
                 probe_grid=None, transparent_objects=None, decals=None,
                 water_height=None, time: float = 0.0,
                 profile_stages: bool = False, binning: str = "tri",
                 tile_qmin=None):
    """One rasterized-mode frame: (ldr (H, W, 3) in [0, 1], new frame
    state (None without one), aux).

    The frame's randomness is injected: `jitter` ((2,), the raster
    primary's sub-pixel offset, pixel centres by default) or `sampler` (the
    ray primary's per-pixel jitter).  Options: `point_lights` (with
    `point_shadow_maps`, one `PointShadowMap` or None per light, they shade
    per light; without, through the Forward+ tile lists), `spot_lights`
    (with `spot_shadow_maps` likewise), `probe_grid` (its irradiance as the
    ambient term), `decals`, `transparent_objects`, `water_height` (the
    water plane, its waves at `time` seconds), and the settings'
    `enable_sss` / `enable_rt_reflections`.  The raster primary takes
    `binning` and `tile_qmin` (`raster.closest_hit_raster`'s: "group", or
    last frame's `aux["tile_qmin"]` for the group path's occlusion
    feedback).  aux holds "tile_qmin" (the raster primary's; None for the
    ray primary), "ao", "shadow",
    "gbuffer", "ambient", "hdr" (pre-tonemap), "ssr_confidence" and
    "rt_reflections" where SSR / RT reflections ran and, with
    `profile_stages`, "stage_ms" (one synchronize at the end of the
    frame)."""
    stage = profiling.Stages("raster", profile_stages, camera.position.device)
    with stage("gbuffer"):
        gb = render_gbuffer(scene, camera, width, height,
                            prev_camera=prev_camera, jitter=jitter,
                            sampler=sampler, primary=settings.primary,
                            binning=binning, tile_qmin=tile_qmin)
        if decals is not None:
            from .decals import apply_decals

            gb = apply_decals(gb, decals)
    with stage("effects"):
        half = (_HalfRes.of(gb, frame_state) if settings.half_res_effects
                else None)
        lit, ao, updates = _effects(scene, camera, gb, shadow_maps,
                                    frame_state, half, settings, width, height)
    with stage("opaque"):
        color, ambient = _opaque(scene, camera, gb, lit, ao, settings, width,
                                 height, point_lights, point_shadow_maps,
                                 spot_lights, spot_shadow_maps, probe_grid)
    with stage("reflections"):
        color, rt_refl, conf, ssr_updates = _reflections(
            scene, camera, color, gb, frame_state, half, settings)
        updates.update(ssr_updates)
    with stage("compose"):
        color = _compose(scene, camera, color, gb, width, height,
                         transparent_objects, water_height, time)
    with stage("taa"):
        color, new_state = _taa(color, gb, frame_state, updates, settings)
    with stage("post"):
        ldr = _post(color, settings)
    aux = {"ao": ao, "shadow": lit, "gbuffer": gb, "ambient": ambient,
           "hdr": color, "tile_qmin": gb.tile_qmin}
    if conf is not None:
        aux["ssr_confidence"] = conf
    if rt_refl is not None:
        aux["rt_reflections"] = rt_refl
    if profile_stages:
        aux["stage_ms"] = stage.ms()
    return ldr, new_state, aux


def render_frame_with_shadows(scene: Scene, camera: Camera, width: int,
                              height: int,
                              settings: RendererSettings = RendererSettings(),
                              shadow_resolution: int = 512, **kw):
    """Fit and render the sun cascades, then the frame."""
    maps = fit_cascades(camera.position, -scene.sky.sun_direction)
    maps = render_sun_shadow_maps(scene.bvh, maps, resolution=shadow_resolution)
    return render_frame(scene, camera, width, height, settings,
                        shadow_maps=maps, **kw)


# The cascade tints of the "visualize_cascades" mode.
CASCADE_COLORS = ((1.0, 0.3, 0.3), (0.3, 1.0, 0.3), (0.3, 0.3, 1.0),
                  (1.0, 1.0, 0.3))
RENDER_MODES = ("rasterized", "path_traced", "visualize_cascades")


def render_mode(scene: Scene, camera: Camera, width: int, height: int,
                mode: str = "rasterized", settings=None, spp: int = 8,
                sampler=None, **kw):
    """The renderer's three modes, each an (H, W, 3) image: "rasterized"
    (`render_frame_with_shadows`, its tonemapped frame; `kw` go to it),
    "path_traced" (`pathtracer.render` at `spp` samples, filmic
    tonemapped) and "visualize_cascades" (albedo times the sun's shadow
    with each cascade tinted, black off the surfaces).  `settings`: the
    mode's (RendererSettings or PathTracerSettings; defaults when None);
    `sampler` draws the ray primary's or the path tracer's numbers."""
    if mode == "rasterized":
        return render_frame_with_shadows(
            scene, camera, width, height, settings or RendererSettings(),
            sampler=sampler, **kw)[0]
    if mode == "path_traced":
        from .pathtracer import PathTracerSettings, render, tonemap_filmic

        img, _ = render(scene, camera, width, height,
                        settings or PathTracerSettings(), spp=spp,
                        sampler=sampler)
        return tonemap_filmic(img)
    if mode == "visualize_cascades":
        gb = render_gbuffer(scene, camera, width, height)
        maps = fit_cascades(camera.position, -scene.sky.sun_direction)
        maps = render_sun_shadow_maps(scene.bvh, maps, resolution=256)
        lit, cascade = sample_sun_shadow(maps, gb.world_pos)
        colors = m.constant(CASCADE_COLORS, torch.float32, lit.device)
        tint = colors[torch.clamp(cascade, 0, 3).long()]
        base = gb.albedo * lit[..., None]
        out = torch.where((cascade >= 0)[..., None], base * 0.4 + tint * 0.6,
                          base)
        return torch.where(gb.hit[..., None], out, 0.0)
    raise ValueError(f"unknown renderer mode {mode!r}; one of {RENDER_MODES}")
