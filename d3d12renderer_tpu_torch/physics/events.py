"""Force fields, triggers, collision events and ray pokes (counterpart of
``d3d12renderer_tpu/physics/events.py``).

Callbacks become event tensors: fixed-shape masks over the static tables,
the previous frame's masks carried by the caller.  Every tensor has the
leading scene axis B.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import maths as m
from .narrow import ContactTable
from .solver import gather_rows
from .types import BodyState, SceneArchetype


def _inside(pos, centers, radii):
    """(B, N, K): body centres pos (B, N, 3) inside the spheres."""
    d = pos[..., :, None, :] - centers + 1e-9
    return m.length(d) < radii


def apply_force_fields(arch: SceneArchetype, state: BodyState):
    """(B, N, 3) forces of the spherical force fields on the bodies whose
    centre lies inside; add them to the state's force before the step."""
    if arch.ff_center.shape[0] == 0:
        return torch.zeros_like(state.pos)
    inside = _inside(state.pos, arch.ff_center, arch.ff_radius)
    return torch.sum(torch.where(inside[..., None], arch.ff_force, 0.0), -2)


def evaluate_triggers(arch: SceneArchetype, state: BodyState,
                      prev_inside: Optional[torch.Tensor] = None):
    """Trigger overlap and enter / leave events: (inside, enter, leave),
    each (B, N, TR) bool.  Carry `inside` to the next call."""
    if arch.trigger_center.shape[0] == 0:
        z = torch.zeros(state.pos.shape[:-1] + (0,), dtype=torch.bool,
                        device=state.pos.device)
        return z, z, z
    inside = _inside(state.pos, arch.trigger_center, arch.trigger_radius)
    if prev_inside is None:
        prev_inside = torch.zeros_like(inside)
    return inside, inside & ~prev_inside, prev_inside & ~inside


class CollisionEvents(NamedTuple):
    begin: torch.Tensor            # (B, P) rows newly in contact
    end: torch.Tensor              # (B, P) rows leaving contact
    active: torch.Tensor           # (B, P) carry to the next step
    approach_speed: torch.Tensor   # (B, P) normal closing speed


def collision_events(contacts: ContactTable, vel, omega,
                     prev_active: Optional[torch.Tensor] = None,
                     pos=None) -> CollisionEvents:
    """Begin / end contact events with the closing speed along the normal
    at each row's first point.  vel / omega / pos (B, S, 3) are indexed by
    the rows' bodies; `pos` (the bodies' centres) gives the angular term
    its lever arm, and without it the angular term is left out."""
    active = contacts.active
    if prev_active is None:
        prev_active = torch.zeros_like(active)
    ia, ib = contacts.body_a, contacts.body_b
    va, vb = gather_rows(vel, ia), gather_rows(vel, ib)
    if pos is not None:
        p = contacts.point[..., 0, :]
        va = va + m.cross(gather_rows(omega, ia), p - gather_rows(pos, ia))
        vb = vb + m.cross(gather_rows(omega, ib), p - gather_rows(pos, ib))
    approach = -torch.sum((vb - va) * contacts.normal, -1)
    return CollisionEvents(
        begin=active & ~prev_active,
        end=prev_active & ~active,
        active=active,
        approach_speed=torch.where(active, torch.clamp(approach, min=0.0),
                                   0.0))


def _add_at_body(state: BodyState, body, force, torque) -> BodyState:
    """Add (B, 3) force and torque to each scene's body `body` (B,)."""
    idx = body[:, None, None].expand(-1, 1, 3)
    return state.replace(force=state.force.scatter_add(1, idx, force[:, None]),
                         torque=state.torque.scatter_add(1, idx,
                                                         torque[:, None]))


def ray_poke(arch: SceneArchetype, state: BodyState, origin, direction,
             strength: float = 1000.0, exact: bool = False) -> BodyState:
    """Push the nearest body each ray hits with `strength` along the ray,
    at the hit point.  origin / direction (3,) or (B, 3).  The default
    intersects the colliders' bounding spheres; `exact=True` takes
    `raycast.ray_cast`'s exact hit."""
    dev = state.pos.device
    batch = state.pos.shape[0]
    origin = torch.as_tensor(origin, dtype=torch.float32,
                             device=dev).expand(batch, 3)
    direction = m.noz(torch.as_tensor(direction, dtype=torch.float32,
                                      device=dev)).expand(batch, 3)
    rows = torch.arange(batch, device=dev)

    if exact:
        from .raycast import ray_cast

        h = ray_cast(arch, state, origin, direction)
        body_hit = h.hit & (h.body >= 0)
        body = torch.clamp(h.body, 0, state.pos.shape[-2] - 1)
        force = direction * strength * body_hit[:, None]
        torque = m.cross(h.point - state.pos[rows, body], force)
        return _add_at_body(state, body, force, torque)

    from .collide import collider_world_poses

    wpos, _ = collider_world_poses(arch, state)
    r = arch.col_bound_radius
    oc = wpos - origin[:, None]
    t_close = torch.sum(oc * direction[:, None], -1)
    perp = oc - direction[:, None] * t_close[..., None]
    miss_sq = torch.sum(perp * perp, -1)
    hit = (miss_sq < r * r) & (t_close > 0)
    t_hit = torch.where(hit, t_close, torch.inf)
    best = torch.argmin(t_hit, dim=-1)
    any_hit = torch.isfinite(t_hit[rows, best])
    body = arch.col_body[best]
    point = origin + direction * t_close[rows, best][:, None]
    force = direction * strength * any_hit[:, None]
    torque = m.cross(point - state.pos[rows, body], force)
    return _add_at_body(state, body, force, torque)
