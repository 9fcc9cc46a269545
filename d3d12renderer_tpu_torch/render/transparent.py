"""The transparent pass: objects composited back to front per pixel over
the opaque frame (counterpart of ``d3d12renderer_tpu/render/transparent.py``).

Each object has its own BVH; the camera rays are cast against it in one
closest-hit query (a small object's table takes the brute-force ray
kernel on the card), its hits are depth-tested against the opaque surface
and shaded with the sun and the sky, and the fragments are blended per
pixel, farthest first.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from ..core import maths as m
from . import bvh as bvh_mod
from .pathtracer import Sky


class TransparentObject(NamedTuple):
    bvh: object                        # render.bvh.BVH of this object alone
    color: Tuple[float, float, float]
    alpha: float


def transparent_pass(color, gb, camera, objects: List[TransparentObject],
                     sky: Optional[Sky] = None):
    """`color` (H, W, 3) with every object blended over it; `gb` the opaque
    G-buffer (the depth test)."""
    if not objects:
        return color
    h, w = gb.depth.shape
    dev = color.device
    d = m.noz(gb.world_pos - camera.position).reshape(-1, 3)
    o = camera.position.expand(d.shape)
    t_opaque = torch.where(gb.hit, torch.linalg.norm(
        gb.world_pos - camera.position + 1e-9, dim=-1), torch.inf)
    if sky is not None:
        to_sun = m.noz(sky.sun_direction)
        sun_irr = sky.sun_radiance * 0.05
    else:
        to_sun = m.noz(m.constant((0.3, 0.8, 0.5), torch.float32, dev))
        sun_irr = 3.0

    ts, rgbs = [], []
    for obj in objects:
        res = bvh_mod.closest_hit(obj.bvh, o, d)
        n = bvh_mod.hit_attributes(obj.bvh, res)[0]
        ndl = torch.clamp(torch.sum(n * to_sun, -1), min=0.0)
        if sky is not None:
            up = torch.clamp(n[:, 1:2] * 0.5 + 0.5, 0.0, 1.0)
            ambient = sky.horizon * (1 - up) + sky.zenith * up
        else:
            ambient = 0.3
        tint = m.constant(tuple(float(c) for c in obj.color), torch.float32,
                          dev)
        shade = tint * (ndl[:, None] * sun_irr / math.pi + ambient * 0.5)
        t = torch.where(res["hit"], res["t"], torch.inf).reshape(h, w)
        ts.append(torch.where(t < t_opaque, t, torch.inf))   # depth test
        rgbs.append(shade.reshape(h, w, 3))
    ts = torch.stack(ts)                                      # (K, H, W)
    rgbs = torch.stack(rgbs)                                  # (K, H, W, 3)
    alphas = m.constant(tuple(float(obj.alpha) for obj in objects),
                        torch.float32, dev)
    k = len(objects)
    layer = torch.arange(k, device=dev)[:, None, None]

    out = color
    for _ in range(k):                  # farthest remaining fragment first
        far = torch.where(torch.isinf(ts), -torch.inf, ts)
        i = torch.argmax(far, dim=0)                          # (H, W)
        t_i = torch.gather(ts, 0, i[None])[0]
        rgb_i = torch.gather(rgbs, 0, i[None, ..., None].expand(
            1, h, w, 3))[0]
        a_i = alphas[i][..., None]
        out = torch.where(torch.isfinite(t_i)[..., None],
                          out * (1 - a_i) + rgb_i * a_i, out)
        ts = torch.where(layer == i[None], torch.inf, ts)
    return out
