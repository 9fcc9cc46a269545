"""The rasterized frame, trimmed to the options the atrium's raster frame
uses.  Stages, in order: G-buffer (the raster primary) -> effects (the sun
shadow term from the cascades, HBAO; half-res with temporal accumulation
and a bilateral upsample when `half_res_effects`) -> opaque (sun BRDF,
sky-tinted ambient, emissive) -> reflections (SSR) -> compose (sky where
nothing was hit) -> TAA -> post (bloom, tonemap, sharpen)."""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional

import torch

from ..core import maths as m
from . import post
from .camera import Camera
from .gbuffer import GBuffer, render_gbuffer
from .shadows import SunShadowMaps, sample_sun_shadow


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
        raise NotImplementedError("the frozen reference has no screen-space "
                                  "shadows: the raster cell's settings leave "
                                  "them off")
    return lit, ao, updates


def _fresnel_schlick(cos_t, f0):
    return f0 + (1.0 - f0) * torch.clamp(1.0 - cos_t, 0.0, 1.0)[..., None] ** 5


def _ggx_d(n_dot_h, alpha):
    a2 = alpha * alpha
    denom = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(math.pi * denom * denom, min=1e-8)


def _smith_g(n_dot_v, n_dot_l, alpha):
    k = alpha * alpha / 2.0
    gv = n_dot_v / torch.clamp(n_dot_v * (1 - k) + k, min=1e-8)
    gl = n_dot_l / torch.clamp(n_dot_l * (1 - k) + k, min=1e-8)
    return gv * gl


def eval_brdf_pixel(n, v, l, albedo, roughness, metallic):
    """Cook-Torrance GGX specular + Lambert diffuse times n.l, on
    image-shaped inputs (..., 3) / (...)."""
    alpha = torch.clamp(roughness * roughness, min=1e-3)
    h = m.noz(v + l)
    n_dot_v = torch.clamp(torch.sum(n * v, -1), min=1e-4)
    n_dot_l = torch.clamp(torch.sum(n * l, -1), min=0.0)
    n_dot_h = torch.clamp(torch.sum(n * h, -1), 0.0, 1.0)
    v_dot_h = torch.clamp(torch.sum(v * h, -1), min=1e-4)
    f0 = 0.04 * (1.0 - metallic[..., None]) + albedo * metallic[..., None]
    fr = _fresnel_schlick(v_dot_h, f0)
    d = _ggx_d(n_dot_h, alpha)
    g = _smith_g(n_dot_v, n_dot_l, alpha)
    spec = fr * (d * g / torch.clamp(4.0 * n_dot_v * n_dot_l, min=1e-8))[..., None]
    diff = albedo * (1.0 - metallic[..., None]) * (1.0 - fr) / math.pi
    return (diff + spec) * n_dot_l[..., None]


def sky_radiance(scene, d):
    """The gradient sky and the sun disc for directions d (R, 3)."""
    cos_sun = torch.sum(d * scene.sun_direction, -1, keepdim=True)
    sun = torch.where(cos_sun > 0.9995, scene.sun_radiance, 0.0)
    y = d[..., 1:2]
    t = torch.clamp(y, 0.0, 1.0) ** 0.6
    col = scene.horizon * (1 - t) + scene.zenith * t
    col = torch.where(y < 0, scene.ground, col)
    return col + sun


def _opaque(scene, camera, gb, lit, ao, settings):
    sun_l = scene.sun_direction
    v = m.noz(camera.position - gb.world_pos)
    f_sun = eval_brdf_pixel(gb.normal, v, sun_l.expand(gb.normal.shape),
                            gb.albedo, gb.roughness, gb.metallic)
    color = f_sun * (scene.sun_radiance * 0.05) * lit[..., None]
    up = torch.clamp(gb.normal[..., 1:2] * 0.5 + 0.5, 0.0, 1.0)
    ambient = scene.horizon * (1 - up) + scene.zenith * up
    color = color + gb.albedo * ambient * settings.ambient_strength * ao[..., None]
    return color + gb.emissive


def _reflections(camera, color, gb, frame_state, half, settings):
    """The SSR resolve: (color, history updates)."""
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
    sky = sky_radiance(scene, d.reshape(-1, 3)).reshape(height, width, 3)
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


def render_frame(scene, camera: Camera, width: int, height: int,
                 settings: RendererSettings,
                 shadow_maps: Optional[SunShadowMaps] = None,
                 frame_state: Optional[FrameState] = None,
                 prev_camera: Optional[Camera] = None, jitter=None):
    """One frame: (ldr (H, W, 3) in [0, 1], new frame state)."""
    gb = render_gbuffer(scene, camera, width, height, prev_camera=prev_camera,
                        jitter=jitter)
    half = _HalfRes.of(gb, frame_state) if settings.half_res_effects else None
    lit, ao, updates = _effects(scene, camera, gb, shadow_maps, frame_state,
                                half, settings, width, height)
    color = _opaque(scene, camera, gb, lit, ao, settings)
    color, ssr_updates = _reflections(camera, color, gb, frame_state, half,
                                      settings)
    updates.update(ssr_updates)
    color = _compose(scene, camera, color, gb, width, height)
    color, new_state = _taa(color, gb, frame_state, updates, settings)
    return _post(color, settings), new_state
