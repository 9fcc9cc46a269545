"""Particle systems (counterpart of ``d3d12renderer_tpu/particles/
systems.py``): fire, smoke, debris and boids, each an emit / simulate pair
for `particles.step_pool`, and the fire's atlas frame by age.

An emit function `emit(generator, k, draws=None)` takes its draws from
`draws` when given (the tests inject the JAX package's), else from the
generator in the order listed:

* fire: `{"radius": (k,), "angle": (k,), "speed": (k,), "life": (k,)}`
  uniforms;
* smoke: `{"position": (k, 3), "velocity": (k, 3)}` standard normals and
  `{"life": (k,)}` uniforms;
* debris: `{"direction": (k, 3)}` standard normals, `{"speed": (k,)}`
  uniforms;
* boids: `{"position": (k, 3), "velocity": (k, 3)}` standard normals.

The splat of particles onto a finished frame (`splat_particles`) is the
additive composite of examples/showcase.py.
"""

from __future__ import annotations

import math
from functools import partial

import numpy as np
import torch

from .particles import ParticlePool, create_pool, step_pool

GRAVITY = -9.81


def _draws(generator, draws, device, spec):
    """`draws` as float32 tensors on `device`, else `spec`'s (name, shape,
    "u" or "n") drawn from `generator` in order."""
    if draws is not None:
        return {k: torch.as_tensor(np.array(v, np.float32), device=device)
                for k, v in draws.items()}
    out = {}
    for name, shape, kind in spec:
        f = torch.rand if kind == "u" else torch.randn
        out[name] = f(shape, generator=generator, device=device)
    return out


def _vec(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


# Fire: rising, intensity fading with age.

def make_fire_system(origin=(0.0, 0.0, 0.0), capacity=1024, emit_rate=120.0):
    def emit(generator, k, draws=None):
        dev = generator.device
        d = _draws(generator, draws, dev, (("radius", (k,), "u"),
                                           ("angle", (k,), "u"),
                                           ("speed", (k,), "u"),
                                           ("life", (k,), "u")))
        r = torch.sqrt(d["radius"]) * 0.25
        th = d["angle"] * 2 * math.pi
        zero = torch.zeros(k, device=dev)
        pos = _vec(origin, dev) + torch.stack(
            [r * torch.cos(th), zero, r * torch.sin(th)], -1)
        vel = torch.stack([zero, 1.0 + d["speed"], zero], -1)
        return {"position": pos, "velocity": vel,
                "lifetime": 0.8 + 0.6 * d["life"],
                "intensity": torch.ones(k, device=dev)}

    def sim(pool: ParticlePool, dt):
        t01 = torch.clamp(pool.age / torch.clamp(pool.lifetime, min=1e-4),
                          0, 1)
        swirl = torch.stack([
            torch.sin(pool.position[:, 2] * 6 + pool.age * 4),
            torch.zeros_like(pool.age),
            torch.cos(pool.position[:, 0] * 6 + pool.age * 4),
        ], -1) * 0.4
        vel = pool.velocity + (_vec([0.0, 1.6, 0.0], pool.age.device)
                               + swirl) * dt
        return {"position": pool.position + vel * dt, "velocity": vel,
                "intensity": (1.0 - t01) ** 1.5}

    return {"create": lambda generator: create_pool(
                capacity, generator, extra={"intensity": ()}),
            "step": partial(step_pool, emit_rate=emit_rate, emit_fn=emit,
                            sim_fn=sim)}


def fire_atlas_frame(age, lifetime, num_frames=16):
    """Atlas frame index by normalised age."""
    t01 = torch.clamp(age / torch.clamp(lifetime, min=1e-4), 0.0, 0.999)
    return (t01 * num_frames).to(torch.int32)


# Smoke: slow rise, growth, drift with the wind.

def make_smoke_system(origin=(0.0, 0.0, 0.0), capacity=1024, emit_rate=40.0,
                      wind=(0.4, 0.0, 0.0)):
    def emit(generator, k, draws=None):
        dev = generator.device
        d = _draws(generator, draws, dev, (("position", (k, 3), "n"),
                                           ("velocity", (k, 3), "n"),
                                           ("life", (k,), "u")))
        return {"position": _vec(origin, dev) + 0.1 * d["position"],
                "velocity": _vec([0.0, 0.8, 0.0], dev) + 0.15 * d["velocity"],
                "lifetime": 2.5 + d["life"],
                "size": torch.full((k,), 0.2, device=dev)}

    def sim(pool, dt):
        t01 = torch.clamp(pool.age / torch.clamp(pool.lifetime, min=1e-4),
                          0, 1)
        vel = pool.velocity * (1 - 0.5 * dt) + _vec(wind, t01.device) * dt
        return {"position": pool.position + vel * dt, "velocity": vel,
                "size": 0.2 + 0.8 * t01}

    return {"create": lambda generator: create_pool(
                capacity, generator, extra={"size": ()}),
            "step": partial(step_pool, emit_rate=emit_rate, emit_fn=emit,
                            sim_fn=sim)}


# Debris: ballistic, bouncing off a ground plane.

def make_debris_system(origin=(0.0, 1.0, 0.0), capacity=512, emit_rate=0.0,
                       ground_height=0.0, restitution=0.4):
    def emit(generator, k, draws=None):
        dev = generator.device
        d = _draws(generator, draws, dev, (("direction", (k, 3), "n"),
                                           ("speed", (k,), "u")))
        dirs = d["direction"] / torch.linalg.norm(d["direction"], dim=-1,
                                                  keepdim=True)
        dirs = torch.cat([dirs[:, :1], torch.abs(dirs[:, 1:2]) + 0.5,
                          dirs[:, 2:]], -1)
        speed = 3.0 + 3.0 * d["speed"]
        return {"position": _vec(origin, dev).expand(k, 3),
                "velocity": dirs * speed[:, None],
                "lifetime": torch.full((k,), 4.0, device=dev)}

    def sim(pool, dt):
        dev = pool.age.device
        vel = pool.velocity + _vec([0.0, GRAVITY, 0.0], dev) * dt
        pos = pool.position + vel * dt
        below = pos[:, 1] < ground_height
        vel = torch.where(below[:, None],
                          vel * _vec([0.7, -restitution, 0.7], dev), vel)
        pos = torch.cat([pos[:, :1], torch.clamp(pos[:, 1:2],
                                                 min=ground_height),
                         pos[:, 2:]], -1)
        return {"position": pos, "velocity": vel}

    return {"create": lambda generator: create_pool(capacity, generator),
            "step": partial(step_pool, emit_rate=emit_rate, emit_fn=emit,
                            sim_fn=sim)}


# Boids: flocking (cohesion, separation, alignment, a pull home).

def make_boid_system(center=(0.0, 5.0, 0.0), capacity=256, emit_rate=60.0,
                     neighbor_radius=2.0, max_speed=4.0):
    def emit(generator, k, draws=None):
        dev = generator.device
        d = _draws(generator, draws, dev, (("position", (k, 3), "n"),
                                           ("velocity", (k, 3), "n")))
        return {"position": _vec(center, dev) + d["position"],
                "velocity": d["velocity"],
                "lifetime": torch.full((k,), 1e9, device=dev)}

    def sim(pool, dt):
        p, v, alive = pool.position, pool.velocity, pool.alive
        diff = p[None, :, :] - p[:, None, :]
        dist = torch.linalg.norm(diff + 1e-6, dim=-1)
        near = (dist < neighbor_radius) & alive[None, :] & alive[:, None]
        near = near & ~torch.eye(p.shape[0], dtype=torch.bool,
                                 device=p.device)
        cnt = torch.clamp(near.sum(-1, keepdim=True), min=1)
        cohesion = torch.sum(torch.where(near[..., None], diff, 0.0), 1) / cnt
        separation = -torch.sum(torch.where(
            near[..., None], diff / (dist * dist + 0.1)[..., None], 0.0), 1)
        alignment = torch.sum(torch.where(near[..., None], v[None], 0.0),
                              1) / cnt - v
        home = _vec(center, p.device) - p
        acc = 0.8 * cohesion + 2.0 * separation + 0.5 * alignment + 0.3 * home
        v = v + acc * dt
        speed = torch.linalg.norm(v + 1e-9, dim=-1, keepdim=True)
        v = torch.where(speed > max_speed, v / speed * max_speed, v)
        return {"position": p + v * dt, "velocity": v}

    return {"create": lambda generator: create_pool(capacity, generator),
            "step": partial(step_pool, emit_rate=emit_rate, emit_fn=emit,
                            sim_fn=sim)}


def splat_particles(img, camera, positions, alive, color, radius_px=2):
    """Particles added onto a finished (H, W, 3) frame as (2r+1)^2 screen
    squares of `color` x 0.5 (the additive particle composite; duplicate
    pixels accumulate).  Particles behind the camera, within 0.1 of it or
    off screen add nothing."""
    from ..core import maths as m

    h, w, _ = img.shape
    view = m.quat_inv_rotate(camera.rotation[None],
                             positions - camera.position)
    z = torch.clamp(-view[:, 2], min=1e-3)
    half_h = torch.tan(torch.tensor(camera.v_fov / 2, device=img.device))
    u = (view[:, 0] / (z * half_h * camera.aspect)) * 0.5 + 0.5
    v = (-view[:, 1] / (z * half_h)) * 0.5 + 0.5
    px = torch.clamp((u * (w - 1)).to(torch.int32), 0, w - 1).long()
    py = torch.clamp((v * (h - 1)).to(torch.int32), 0, h - 1).long()
    ok = alive & (-view[:, 2] > 0.1) & (u > 0) & (u < 1) & (v > 0) & (v < 1)
    add = torch.where(ok[:, None], torch.as_tensor(
        color, dtype=img.dtype, device=img.device), 0.0) * 0.5
    out = img.clone()
    for dy in range(-radius_px, radius_px + 1):
        for dx in range(-radius_px, radius_px + 1):
            out.index_put_((torch.clamp(py + dy, 0, h - 1),
                            torch.clamp(px + dx, 0, w - 1)), add,
                           accumulate=True)
    return out
