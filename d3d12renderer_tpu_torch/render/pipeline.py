"""The rasterized frame (counterpart of ``d3d12renderer_tpu/render/pipeline.py``
`render_frame`, one dispatch).

Stages, in order: G-buffer (raster or ray primary visibility) -> effects
(sun shadow term from the cascades, HBAO; half-res with temporal
accumulation and a bilateral upsample when `half_res_effects`) -> opaque
(sun BRDF + sky-tinted ambient + emissive) -> reflections (SSR) -> compose
(sky where nothing was hit) -> TAA -> post (bloom, tonemap, sharpen).
The JAX package's per-pass / grouped / fused dispatch modes give identical
frames and exist for its TPU compiler; here the stages simply run in turn.

Not ported yet (a caller who asks for them gets NotImplementedError, never
a frame without them): screen-space shadows, ray-traced reflections,
point and spot lights and their shadows, light probes, decals,
transparents and water.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, replace
from typing import Optional

import torch

from ..core import maths as m
from . import post
from .camera import Camera
from .gbuffer import GBuffer, render_gbuffer
from .lights import eval_brdf_pixel
from .pathtracer import Scene, sky_radiance
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
    # AO and SSR at half resolution with temporal accumulation and a
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
    half-res AO / SSR accumulation buffers."""

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
    """The half-res effects' inputs, shared by AO and SSR."""

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


def _effects(scene, gb, shadow_maps, frame_state, half, settings, width,
             height):
    """Sun shadow term and AO; history updates for the half-res path."""
    dev = gb.depth.device
    updates = {}
    if settings.enable_shadows and shadow_maps is not None:
        lit, _ = sample_sun_shadow(shadow_maps, gb.world_pos)
    else:
        lit = torch.ones((height, width), device=dev)
    if not settings.enable_ao:
        return lit, torch.ones((height, width), device=dev), updates
    if half is None:
        return lit, post.hbao(gb.view_pos, gb.view_normal, settings.hbao), updates
    ao_low = post.hbao(half.view_pos, half.normal, settings.hbao)
    if frame_state is not None and frame_state.ao_history is not None:
        ao_low = post.temporal_accumulate(ao_low, frame_state.ao_history,
                                          half.motion, first=half.first)
        updates["ao_history"] = ao_low
    return lit, post.bilateral_upsample(ao_low, half.depth_low,
                                        half.depth_full), updates


def _opaque(scene, camera, gb, lit, ao, settings):
    sun_l = scene.sky.sun_direction
    v = m.noz(camera.position - gb.world_pos)
    f_sun = eval_brdf_pixel(gb.normal, v, sun_l.expand(gb.normal.shape),
                            gb.albedo, gb.roughness, gb.metallic)
    color = f_sun * (scene.sky.sun_radiance * 0.05) * lit[..., None]
    up = torch.clamp(gb.normal[..., 1:2] * 0.5 + 0.5, 0.0, 1.0)
    ambient = scene.sky.horizon * (1 - up) + scene.sky.zenith * up
    color = color + gb.albedo * ambient * settings.ambient_strength * ao[..., None]
    return color + gb.emissive, ambient


def _reflections(camera, color, gb, frame_state, half, settings):
    """SSR resolve; history updates for the half-res path."""
    updates = {}
    if not settings.enable_ssr:
        return color, updates
    f0 = 0.04 * (1 - gb.metallic[..., None]) + gb.albedo * gb.metallic[..., None]
    tan_half = math.tan(camera.v_fov * 0.5)
    if half is None:
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
    return color + refl * conf[..., None] * f0, updates


def _compose(scene, camera, color, gb, width, height):
    d = m.noz(gb.world_pos - camera.position)
    sky = sky_radiance(scene.sky, d.reshape(-1, 3)).reshape(height, width, 3)
    return torch.where(gb.hit[..., None], color, sky)


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


class _StageClock:
    """Per-stage times when asked for: CUDA events on the card (read after
    one synchronize at the end), the host clock on the CPU."""

    def __init__(self, on: bool, device):
        self.on, self.cuda = on, device.type == "cuda"
        self.marks = []

    def mark(self, name):
        if not self.on:
            return
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))

    def ms(self):
        if self.cuda:
            torch.cuda.synchronize()
        out = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            out[name] = a.elapsed_time(b) if self.cuda else 1e3 * (b - a)
        return out


def _refuse(**unported):
    for name, value in unported.items():
        if value:
            raise NotImplementedError(
                f"{name} is not ported to the PyTorch raster frame yet")


def render_frame(scene: Scene, camera: Camera, width: int, height: int,
                 settings: RendererSettings = RendererSettings(),
                 shadow_maps: Optional[SunShadowMaps] = None,
                 frame_state: Optional[FrameState] = None,
                 prev_camera: Optional[Camera] = None, jitter=None,
                 sampler=None, point_lights=None, spot_lights=None,
                 spot_shadow_maps=None, point_shadow_maps=None,
                 probe_grid=None, transparent_objects=None, decals=None,
                 water_height=None, profile_stages: bool = False):
    """One rasterized-mode frame: (ldr (H, W, 3) in [0, 1], new frame
    state (None without one), aux).

    The frame's randomness is injected: `jitter` ((2,), the raster
    primary's sub-pixel offset, pixel centres by default) or `sampler` (the
    ray primary's per-pixel jitter).  aux holds "ao", "shadow", "gbuffer",
    "ambient", "hdr" (pre-tonemap) and, with `profile_stages`, "stage_ms"
    (one synchronize at the end of the frame)."""
    _refuse(enable_sss=settings.enable_sss,
            enable_rt_reflections=settings.enable_rt_reflections,
            point_lights=point_lights is not None,
            spot_lights=spot_lights is not None,
            spot_shadow_maps=spot_shadow_maps is not None,
            point_shadow_maps=point_shadow_maps is not None,
            probe_grid=probe_grid is not None,
            transparent_objects=bool(transparent_objects),
            decals=decals is not None, water_height=water_height is not None)
    clock = _StageClock(profile_stages, camera.position.device)
    clock.mark("start")
    gb = render_gbuffer(scene, camera, width, height, prev_camera=prev_camera,
                        jitter=jitter, sampler=sampler,
                        primary=settings.primary)
    clock.mark("gbuffer")
    half = _HalfRes.of(gb, frame_state) if settings.half_res_effects else None
    lit, ao, updates = _effects(scene, gb, shadow_maps, frame_state, half,
                                settings, width, height)
    clock.mark("effects")
    color, ambient = _opaque(scene, camera, gb, lit, ao, settings)
    clock.mark("opaque")
    color, ssr_updates = _reflections(camera, color, gb, frame_state, half,
                                      settings)
    updates.update(ssr_updates)
    clock.mark("reflections")
    color = _compose(scene, camera, color, gb, width, height)
    clock.mark("compose")
    color, new_state = _taa(color, gb, frame_state, updates, settings)
    clock.mark("taa")
    ldr = _post(color, settings)
    clock.mark("post")
    aux = {"ao": ao, "shadow": lit, "gbuffer": gb, "ambient": ambient,
           "hdr": color}
    if profile_stages:
        aux["stage_ms"] = clock.ms()
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
