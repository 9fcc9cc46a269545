"""Debug visualization: wire primitives, line overlays and outlines
(counterpart of ``d3d12renderer_tpu/render/debug_viz.py``; reference
src/rendering/debug_visualization.h:16-40, src/rendering/outline.h:6).
Debug draws are world-space segment lists splatted onto the rendered
image; outlines come from the G-buffer's object ids (the stencil
equivalent), with the JAX module's wrap-around rolls at the image edges.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import maths as m
from .camera import Camera


def wire_box(center, half_extents, rotation=None):
    """12 edges of a box -> (12, 2, 3) segment list."""
    c = np.asarray(center, np.float32)
    h = np.asarray(half_extents, np.float32)
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                        for z in (-1, 1)], np.float32) * h
    if rotation is not None:
        x, y, z, w = rotation
        rm = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])
        corners = corners @ rm.T
    corners = corners + c
    edges = [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7),
             (0, 4), (1, 5), (2, 6), (3, 7)]
    return np.stack([[corners[a], corners[b]] for a, b in edges])


def wire_sphere(center, radius, segments=24):
    """3 great circles -> (3*segments, 2, 3)."""
    c = np.asarray(center, np.float32)
    segs = []
    for axis in range(3):
        ts = np.linspace(0, 2 * math.pi, segments + 1)
        u = np.zeros(3)
        v = np.zeros(3)
        u[(axis + 1) % 3] = 1
        v[(axis + 2) % 3] = 1
        pts = c + radius * (np.outer(np.cos(ts), u) + np.outer(np.sin(ts), v))
        segs.extend([[pts[i], pts[i + 1]] for i in range(segments)])
    return np.stack(segs).astype(np.float32)


def wire_cone(apex, direction, angle, length, segments=16):
    """Cone outline (reference: debug cone for spot lights)."""
    apex = np.asarray(apex, np.float64)
    d = np.asarray(direction, np.float64)
    d = d / np.linalg.norm(d)
    t = np.array([1.0, 0, 0]) if abs(d[0]) < 0.9 else np.array([0, 1.0, 0])
    u = np.cross(d, t)
    u /= np.linalg.norm(u)
    v = np.cross(d, u)
    r = math.tan(angle) * length
    base = apex + d * length
    ts = np.linspace(0, 2 * math.pi, segments + 1)
    ring = base + r * (np.outer(np.cos(ts), u) + np.outer(np.sin(ts), v))
    segs = [[ring[i], ring[i + 1]] for i in range(segments)]
    for i in range(0, segments, max(segments // 4, 1)):
        segs.append([apex, ring[i]])
    return np.stack(segs).astype(np.float32)


def rasterize_lines(image, segments, color, camera: Camera, samples=48):
    """Splat world-space segments (S, 2, 3) onto an (H, W, 3) image, each
    at `samples` points (the position-color debug pipeline).  Where several
    points land on one pixel the last one decides, as the JAX module's
    scatter does on the CPU: the colour if it is in view, else the pixel
    stays."""
    h, w, _ = image.shape
    dev = image.device
    segments = torch.as_tensor(segments, dtype=torch.float32, device=dev)
    t = torch.linspace(0.0, 1.0, samples, device=dev)
    pts = (segments[:, 0][:, None, :] * (1 - t)[None, :, None]
           + segments[:, 1][:, None, :] * t[None, :, None]).reshape(-1, 3)
    vp = m.quat_inv_rotate(camera.rotation[None], pts - camera.position)
    z = -vp[:, 2]
    tan_half = math.tan(camera.v_fov * 0.5)
    valid = z > camera.near
    u = vp[:, 0] / torch.clamp(z, min=1e-6) / (tan_half * camera.aspect)
    v = -vp[:, 1] / torch.clamp(z, min=1e-6) / tan_half

    def to_pixel(x, n):
        # float -> int32 truncates toward zero and saturates (XLA's cast).
        return torch.clamp((x * 0.5 + 0.5) * (n - 1), -2.0 ** 30,
                           2.0 ** 30).to(torch.int64)

    px, py = to_pixel(u, w), to_pixel(v, h)
    inside = valid & (px >= 0) & (px < w) & (py >= 0) & (py < h)
    flat = torch.clamp(py, 0, h - 1) * w + torch.clamp(px, 0, w - 1)
    order = torch.arange(flat.shape[0], device=dev)
    last = torch.full((h * w,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, flat, order, reduce="amax")
    paint = (last >= 0) & inside[torch.clamp(last, min=0)]
    col = torch.as_tensor(color, dtype=image.dtype, device=dev)
    return torch.where(paint.reshape(h, w, 1), col, image)


def object_outlines(object_id, thickness=1):
    """Edge mask from G-buffer object ids (the stencil outline, reference:
    outline.h marker stencil and dilate)."""
    edges = torch.zeros(object_id.shape, dtype=torch.bool,
                        device=object_id.device)
    for dy, dx in ((0, 1), (1, 0)):
        edges = edges | (m.roll2(object_id, dy, dx) != object_id)
    for _ in range(thickness - 1):
        acc = edges
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                acc = acc | m.roll2(edges, dy, dx)
        edges = acc
    return edges


def draw_outlines(image, object_id, selected_id, color=(1.0, 0.6, 0.1)):
    """Highlight one object's silhouette (reference: editor selection
    outlines)."""
    mask = object_id == selected_id
    edge = torch.zeros_like(mask)
    for dy, dx in ((0, 1), (1, 0), (0, -1), (-1, 0)):
        edge = edge | (mask != m.roll2(mask, dy, dx))
    col = torch.as_tensor(color, dtype=image.dtype, device=image.device)
    return torch.where(edge[..., None], col, image)
