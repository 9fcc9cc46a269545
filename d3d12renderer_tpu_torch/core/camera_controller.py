"""Camera controllers: orbit and fly (counterpart of
``d3d12renderer_tpu/core/camera_controller.py``).

Reference: src/core/camera_controller.h:7 — the editor camera supports
orbit-around-target (MMB/alt) and fly (WASD+mouse) modes with smoothed
motion.  Input here is a plain dataclass (script- or notebook-driven).  The
controllers keep their state on the host in float64; `camera(device=...)`
returns the port's `render.camera.Camera` on a device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..render.camera import Camera, look_at


@dataclass
class OrbitController:
    """Orbit around a target point (reference: camera_controller orbit mode)."""

    target: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    distance: float = 8.0
    yaw: float = 0.6
    pitch: float = 0.4
    min_pitch: float = -1.4
    max_pitch: float = 1.4
    min_distance: float = 0.5

    def rotate(self, d_yaw: float, d_pitch: float):
        self.yaw = (self.yaw + d_yaw) % (2 * math.pi)
        self.pitch = float(np.clip(self.pitch + d_pitch,
                                   self.min_pitch, self.max_pitch))

    def zoom(self, factor: float):
        self.distance = max(self.distance * factor, self.min_distance)

    def pan(self, dx: float, dy: float):
        from . import maths as m

        cam = self.camera(device="cpu")
        axes = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
        right, up = m.quat_rotate(cam.rotation[None], axes).numpy()
        self.target = tuple(np.asarray(self.target)
                            + right * dx * self.distance
                            + up * dy * self.distance)

    def camera(self, device="cuda", **kw) -> Camera:
        cp, sp = math.cos(self.pitch), math.sin(self.pitch)
        cy, sy = math.cos(self.yaw), math.sin(self.yaw)
        offset = np.array([cp * sy, sp, cp * cy]) * self.distance
        return look_at(np.asarray(self.target) + offset, self.target,
                       device=device, **kw)


@dataclass
class FlyController:
    """Free-fly camera (reference: camera_controller fly mode)."""

    position: Tuple[float, float, float] = (0.0, 2.0, 8.0)
    yaw: float = 0.0
    pitch: float = 0.0
    speed: float = 5.0

    def look(self, d_yaw: float, d_pitch: float):
        self.yaw = (self.yaw + d_yaw) % (2 * math.pi)
        self.pitch = float(np.clip(self.pitch + d_pitch, -1.5, 1.5))

    def _basis(self):
        cp, sp = math.cos(self.pitch), math.sin(self.pitch)
        cy, sy = math.cos(self.yaw), math.sin(self.yaw)
        forward = np.array([-cp * sy, sp, -cp * cy])
        right = np.array([cy, 0.0, -sy])
        up = np.cross(right, forward)
        return forward, right, up

    def move(self, dt: float, forward=0.0, right=0.0, up=0.0):
        f, r, u = self._basis()
        self.position = tuple(
            np.asarray(self.position)
            + (f * forward + r * right + u * up) * self.speed * dt
        )

    def camera(self, device="cuda", **kw) -> Camera:
        f, _, _ = self._basis()
        return look_at(self.position, np.asarray(self.position) + f,
                       device=device, **kw)
