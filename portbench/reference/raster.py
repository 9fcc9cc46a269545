"""The raster frame's check: a frame recomputed by the plain reference
(the pipeline's plain PyTorch version, frozen) from the program's frame
state before it (the TAA and half-res histories) and the frame's jitter,
against the program's LDR frame; and a sample of the sun's shadow-map
texels, which the program renders once in its set-up, traced again against
every triangle.  Imports nothing of the program."""

from __future__ import annotations

import torch

from .frozen.render import pipeline
from .frozen.render.shadows import SunShadowMaps
from .pathtrace import Atrium, _default_dtype, _intersect

FRAME_STATE_FIELDS = ("history", "frame_index", "ao_history", "sss_history",
                      "ssr_history", "ssr_conf_history")
SHADOW_FIELDS = ("depth", "origin", "right", "up", "direction", "extent",
                 "z_range")
# An LDR pixel is off where a channel differs by more than this.
PIXEL_TOL = 1e-3
# A shadow-map texel is off where its depth differs by more than this
# share of it (or one is a miss and the other not).
DEPTH_TOL = 1e-3


def settings(config: dict):
    r = config["raster"]
    return pipeline.RendererSettings(primary=r["primary"],
                                     half_res_effects=r["half_res_effects"])


def initial_state(scene: Atrium) -> dict:
    """The frame state before the first frame: no history (zero colour,
    frame 0, full AO and screen-space shadow, no reflections)."""
    dev = scene.mat.device
    h, w = scene.height, scene.width
    return {"history": torch.zeros((h, w, 3), device=dev),
            "frame_index": torch.zeros((), dtype=torch.int32, device=dev),
            "ao_history": torch.ones((h // 2, w // 2), device=dev),
            "sss_history": torch.ones((h // 2, w // 2), device=dev),
            "ssr_history": torch.zeros((h // 2, w // 2, 3), device=dev),
            "ssr_conf_history": torch.zeros((h // 2, w // 2), device=dev)}


def frame(scene: Atrium, config: dict, shadow_maps: dict, state: dict,
          jitter, dtype=torch.float32):
    """The reference's LDR frame (H, W, 3) from the frame state before it
    and the shadow maps, both given as tensors by name."""
    def low(x):
        return x.to(dtype) if x.is_floating_point() else x

    maps = SunShadowMaps(**{k: low(shadow_maps[k]) for k in SHADOW_FIELDS})
    fs = pipeline.FrameState(**{k: low(state[k]) for k in FRAME_STATE_FIELDS})
    with torch.no_grad(), _default_dtype(dtype):
        ldr, _ = pipeline.render_frame(
            scene, scene.camera, scene.width, scene.height, settings(config),
            shadow_maps=maps, frame_state=fs, prev_camera=scene.camera,
            jitter=jitter.to(torch.float32))
    return ldr.float()


def gaps(answer, ref) -> dict:
    """`pixels_off`: the share of pixels, in percent, with a channel off by
    more than PIXEL_TOL; `mean_gap`: the mean absolute difference."""
    diff = (answer - ref).abs()
    diff = torch.where(torch.isfinite(diff), diff, torch.full_like(diff, 1e30))
    return {"pixels_off": 100.0 * float((diff > PIXEL_TOL).any(-1)
                                        .float().mean()),
            "mean_gap": float(diff.mean())}


def texel_depths(scene: Atrium, shadow_maps: dict, texels,
                 dtype=torch.float32):
    """The depth of each sampled texel (cascade, row, column): the closest
    hit of the ray from the texel's centre on the cascade's near plane
    along the light, +inf on a miss, traced in `dtype`."""
    c, iy, ix = texels
    r = shadow_maps["depth"].shape[-1]
    u = (ix.float() + 0.5) / r * 2 - 1
    v = (iy.float() + 0.5) / r * 2 - 1
    ext = shadow_maps["extent"][c][:, None]
    o = (shadow_maps["origin"][c] + shadow_maps["right"][c] * u[:, None] * ext
         + shadow_maps["up"][c] * v[:, None] * ext)
    d = shadow_maps["direction"].expand(o.shape).contiguous()
    with torch.no_grad(), _default_dtype(dtype):
        t, tri, _, _ = _intersect(scene, o.to(dtype), d.to(dtype),
                                  torch.full_like(u, 1e30).to(dtype))
    return torch.where(tri >= 0, t.float(), torch.inf)


def texels_off(got, ref, cascade) -> float:
    """The share, in percent, of a cascade's sampled texels whose depth
    differs from the reference's by more than DEPTH_TOL of it, or where one
    is a miss and the other not: the largest over the cascades."""
    miss_got, miss_ref = torch.isinf(got), torch.isinf(ref)
    far = ((got - ref).abs() > DEPTH_TOL * torch.clamp(ref.abs(), min=1.0))
    off = (miss_got != miss_ref) | (~miss_got & ~miss_ref & far)
    shares = [float(off[cascade == k].float().mean())
              for k in torch.unique(cascade).tolist()]
    return 100.0 * max(shares)
