"""Grid cloth (counterpart of ``d3d12renderer_tpu/physics/cloth.py``):
velocity, position and drift iterations, wind, pinned rows, and particles
projected out of spheres and capsules.

The particle grid is a (..., Y, X, 3) tensor (any leading axes: scenes).
Each of the six constraint groups (stretch, shear, bend) is solved as a
shifted-slice update in two interleaved colors whose pairs share no
particle, so a color solves at once with Gauss-Seidel semantics in this
order.  The JAX package solves the same 12 colors in the same order; the
reference solves its constraints one at a time (a documented divergence,
ROADMAP.md Queue 3).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Tuple

import numpy as np
import torch

from ..core import maths as m

GRAVITY = -9.81

# Constraint groups, (dy, dx) offsets: stretch, shear, bend.
GROUPS = [(0, 1), (1, 0), (1, 1), (1, -1), (0, 2), (2, 0)]


@dataclass
class ClothState:
    positions: torch.Tensor       # (..., Y, X, 3)
    prev_positions: torch.Tensor  # (..., Y, X, 3)
    velocities: torch.Tensor      # (..., Y, X, 3)
    forces: torch.Tensor          # (..., Y, X, 3)

    def replace(self, **kw) -> "ClothState":
        return replace(self, **kw)


@dataclass
class ClothParams:
    inv_mass: torch.Tensor        # (Y, X); 0 pins a particle
    stiffness: float = 0.5
    damping: float = 0.3
    gravity_factor: float = 1.0
    width: float = 1.0
    height: float = 1.0
    # The color masks of the constraint groups, built on first use.
    cache: dict = field(default_factory=dict, repr=False, compare=False)


def create_cloth(width: float, height: float, grid_x: int, grid_y: int,
                 total_mass: float, stiffness: float = 0.5,
                 damping: float = 0.3, gravity_factor: float = 1.0,
                 fix_top_row: bool = True,
                 device="cuda") -> Tuple[ClothParams, ClothState]:
    """A cloth in the local xz plane, its top row (z = 0) pinned unless
    `fix_top_row` is False, on `device`; the state has no leading axis."""
    from ..cuda_build import resolve_device

    device = resolve_device(device)
    ys, xs = np.meshgrid(np.arange(grid_y, dtype=np.float32),
                         np.arange(grid_x, dtype=np.float32), indexing="ij")
    rel_x = xs / (grid_x - 1)
    rel_y = ys / (grid_y - 1)
    pos = np.stack([rel_x * width - width * 0.5, np.zeros_like(rel_x),
                    -rel_y * height], axis=-1).astype(np.float32)
    inv_mass = np.full((grid_y, grid_x), grid_x * grid_y / total_mass,
                       np.float32)
    if fix_top_row:
        inv_mass[0, :] = 0.0
    params = ClothParams(inv_mass=torch.as_tensor(inv_mass, device=device),
                         stiffness=stiffness, damping=damping,
                         gravity_factor=gravity_factor, width=width,
                         height=height)
    p = torch.as_tensor(pos, device=device)
    z = torch.zeros_like(p)
    return params, ClothState(positions=p, prev_positions=p, velocities=z,
                              forces=z)


def _group_slices(arr, dy, dx):
    """(a, b) views of group (dy, dx): both (..., Y - dy, X - |dx|, k)."""
    y, x = arr.shape[-3], arr.shape[-2]
    if dx >= 0:
        return arr[..., :y - dy, :x - dx, :], arr[..., dy:, dx:, :]
    return arr[..., :y - dy, -dx:, :], arr[..., dy:, :x + dx, :]


def _pad_back(delta, dy, dx):
    """A (..., Y - dy, X - |dx|, 3) delta zero-padded back to the grid at
    the pairs' a and b particles."""
    pad = torch.nn.functional.pad
    if dx >= 0:
        return (pad(delta, (0, 0, 0, dx, 0, dy)),
                pad(delta, (0, 0, dx, 0, dy, 0)))
    return (pad(delta, (0, 0, -dx, 0, 0, dy)),
            pad(delta, (0, 0, 0, -dx, dy, 0)))


def _color_masks(params: ClothParams, dy, dx):
    """The two masks splitting group (dy, dx)'s pairs into colors whose
    pairs share no particle; built once per cloth."""
    key = ("colors", dy, dx)
    if key not in params.cache:
        gy, gx = params.inv_mass.shape
        shape = (gy - abs(dy), gx - abs(dx))
        y = np.arange(shape[0])[:, None] * np.ones(shape, np.int64)
        x = np.arange(shape[1])[None, :] * np.ones(shape, np.int64)
        c = (y // dy) % 2 if dy > 0 else (x // abs(dx)) % 2
        params.cache[key] = tuple(
            torch.as_tensor(c == k, device=params.inv_mass.device)
            for k in (0, 1))
    return params.cache[key]


def _rest_distance(params: ClothParams, gy, gx, dy, dx):
    sx = params.width / (gx - 1)
    sy = params.height / (gy - 1)
    return math.sqrt((dx * sx) ** 2 + (dy * sy) ** 2)


def _inv_stiffness(params: ClothParams) -> float:
    """1 / stiffness clipped to [0.01, 1], in float32 as the JAX package."""
    s = np.clip(np.float32(params.stiffness), np.float32(0.01),
                np.float32(1.0))
    return float(np.float32(1.0) / s)


def _solve_positions_once(positions, params: ClothParams):
    """One Gauss-Seidel sweep over every group and color."""
    gy, gx = params.inv_mass.shape
    inv_stiff = _inv_stiffness(params)
    im = params.inv_mass[..., :, :, None]
    for (dy, dx) in GROUPS:
        rest = _rest_distance(params, gy, gx, dy, dx)
        rest_sq = rest * rest
        ima, imb = _group_slices(im, dy, dx)
        inv_mass_sum = (ima[..., 0] + imb[..., 0]) * inv_stiff
        for mask in _color_masks(params, dy, dx):
            pa, pb = _group_slices(positions, dy, dx)
            delta = pb - pa
            len_sq = torch.sum(delta * delta, -1)
            denom = inv_mass_sum * (rest_sq + len_sq)
            active = (inv_mass_sum > 0) & (rest_sq + len_sq > 1e-5) & mask
            k = torch.where(active, (rest_sq - len_sq)
                            / torch.where(denom == 0, 1.0, denom), 0.0)
            da, db = _pad_back(delta * k[..., None], dy, dx)
            positions = positions - da * im + db * im
    return positions


def _solve_velocities_once(velocities, prev_positions, params: ClothParams):
    """One sweep of the velocity constraints, gradients from the previous
    positions."""
    gy, gx = params.inv_mass.shape
    inv_stiff = _inv_stiffness(params)
    im = params.inv_mass[..., :, :, None]
    for (dy, dx) in GROUPS:
        ima, imb = _group_slices(im, dy, dx)
        inv_mass_sum = (ima[..., 0] + imb[..., 0]) * inv_stiff
        ga, gb = _group_slices(prev_positions, dy, dx)
        grad = gb - ga
        denom = torch.sum(grad * grad, -1) * inv_mass_sum
        inv_scaled = torch.where(
            denom != 0, 1.0 / torch.where(denom == 0, 1.0, denom), 0.0)
        for mask in _color_masks(params, dy, dx):
            va, vb = _group_slices(velocities, dy, dx)
            j = -torch.sum(grad * (va - vb), -1) * inv_scaled
            j = torch.where(mask, j, 0.0)
            da, db = _pad_back(grad * j[..., None], dy, dx)
            velocities = velocities + da * im - db * im
    return velocities


def apply_wind(state: ClothState, force) -> ClothState:
    """Add each quad's two triangles' normal-projected share of the wind
    `force` (3,) to their corners' forces."""
    p = state.positions
    if not isinstance(force, torch.Tensor):
        force = m.constant(tuple(float(f) for f in force), p.dtype, p.device)
    tl = p[..., :-1, :-1, :]
    tr = p[..., :-1, 1:, :]
    bl = p[..., 1:, :-1, :]
    br = p[..., 1:, 1:, :]

    def tri_force(a, b, c):
        n = m.cross(b - a, c - a)
        return n * torch.sum(m.noz(n) * force, -1, keepdim=True) / 3.0

    f1 = tri_force(tl, bl, tr)    # on tl, tr, bl
    f2 = tri_force(br, tr, bl)    # on br, tr, bl
    pad = torch.nn.functional.pad
    acc = torch.zeros_like(p)
    acc = acc + pad(f1 + f2, (0, 0, 1, 0, 0, 1))   # tr
    acc = acc + pad(f1 + f2, (0, 0, 0, 1, 1, 0))   # bl
    acc = acc + pad(f1, (0, 0, 0, 1, 0, 1))        # tl
    acc = acc + pad(f2, (0, 0, 1, 0, 1, 0))        # br
    return state.replace(forces=state.forces + acc)


def collide_spheres(positions, centers, radii, margin=0.0):
    """Project particles (..., Y, X, 3) out of spheres: centres (..., S, 3),
    radii (..., S)."""
    d = positions[..., None, :] - centers[..., None, None, :, :]
    dist = m.length(d + 1e-9)
    pen = (radii[..., None, None, :] + margin) - dist
    push = torch.clamp(pen, min=0.0)[..., None] * (d / dist[..., None])
    return positions + torch.sum(push, -2)


def collide_capsules(positions, p0, p1, radii, margin=0.0):
    """Project particles out of capsules of segment ends p0 / p1 (..., S,
    3) and radii (..., S)."""
    a = p0[..., None, None, :, :]
    b = p1[..., None, None, :, :]
    p = positions[..., None, :]
    ab = b - a
    t = torch.clamp(torch.sum((p - a) * ab, -1)
                    / torch.clamp(torch.sum(ab * ab, -1), min=1e-9), 0.0, 1.0)
    d = p - (a + t[..., None] * ab)
    dist = m.length(d + 1e-9)
    pen = (radii[..., None, None, :] + margin) - dist
    push = torch.clamp(pen, min=0.0)[..., None] * (d / dist[..., None])
    return positions + torch.sum(push, -2)


def simulate(params: ClothParams, state: ClothState, dt: float,
             velocity_iterations: int = 0, position_iterations: int = 1,
             drift_iterations: int = 0, collide_fn=None) -> ClothState:
    """One cloth step.  `collide_fn(positions) -> positions` runs after
    each position sweep (e.g. `collide_spheres` with fixed arguments)."""
    im = params.inv_mass[..., None]
    vel = state.velocities
    gravity = m.constant((0.0, GRAVITY * dt * params.gravity_factor, 0.0),
                         vel.dtype, vel.device)
    vel = vel + gravity * (params.inv_mass > 0)[..., None]
    vel = vel + state.forces * im * dt
    prev = state.positions
    pos = prev + vel * dt
    inv_dt = 1.0 / dt if dt > 1e-5 else 1.0

    for _ in range(velocity_iterations):
        vel = _solve_velocities_once(vel, prev, params)
    if velocity_iterations > 0:
        pos = prev + vel * dt

    for _ in range(position_iterations):
        pos = _solve_positions_once(pos, params)
        if collide_fn is not None:
            pos = collide_fn(pos)
    if position_iterations > 0:
        vel = (pos - prev) * inv_dt

    if drift_iterations > 0:
        drift_prev = pos
        for _ in range(drift_iterations):
            pos = _solve_positions_once(pos, params)
            if collide_fn is not None:
                pos = collide_fn(pos)
        vel = vel + (pos - drift_prev) * inv_dt

    vel = vel / (1.0 + dt * params.damping)
    return ClothState(positions=pos, prev_positions=prev, velocities=vel,
                      forces=torch.zeros_like(state.forces))


def cloth_triangle_indices(grid_y: int, grid_x: int) -> np.ndarray:
    """(T, 3) int32 triangle indices of the grid, two per quad."""
    tris = []
    for y in range(grid_y - 1):
        for x in range(grid_x - 1):
            tl = y * grid_x + x
            tr = tl + 1
            bl = tl + grid_x
            br = bl + 1
            tris.append([tl, bl, br])
            tris.append([tl, br, tr])
    return np.array(tris, np.int32)
