"""Particle system core (counterpart of
``d3d12renderer_tpu/particles/particles.py``): a fixed-capacity pool with
masked emission and simulation.  The dead list is `~alive`; emission
claims the first dead slots in index order (a stable argsort), so shapes
stay fixed and nothing is read back to the host.

The JAX pool carries a PRNG key; this pool carries a `torch.Generator` on
its own device, from which each step's emission draws (a tensor built on
the host for every step would wait behind the card's queue).  `step_pool`
also takes the emission's draws (`draws`), as the tests inject the JAX
package's.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, Optional

import torch

from ..cuda_build import resolve_device


@dataclass
class ParticlePool:
    position: torch.Tensor    # (N, 3)
    velocity: torch.Tensor    # (N, 3)
    age: torch.Tensor         # (N,)
    lifetime: torch.Tensor    # (N,)  <= 0 on dead slots
    alive: torch.Tensor       # (N,) bool
    data: Dict[str, torch.Tensor]  # per-system extra channels
    generator: torch.Generator
    emit_carry: torch.Tensor  # () float32 fractional-emission accumulator

    @property
    def capacity(self):
        return self.position.shape[0]

    @property
    def num_alive(self):
        return self.alive.sum()

    def replace(self, **kw) -> "ParticlePool":
        return replace(self, **kw)


def create_pool(capacity: int, generator: torch.Generator,
                extra: Optional[Dict[str, tuple]] = None,
                device=None) -> ParticlePool:
    """An empty pool on the generator's device (or `device`); `extra`:
    {name: trailing shape} channels."""
    device = resolve_device(device if device is not None
                            else generator.device)
    z3 = torch.zeros((capacity, 3), device=device)
    return ParticlePool(
        position=z3, velocity=z3.clone(),
        age=torch.zeros(capacity, device=device),
        lifetime=torch.zeros(capacity, device=device),
        alive=torch.zeros(capacity, dtype=torch.bool, device=device),
        data={name: torch.zeros((capacity,) + tuple(shape), device=device)
              for name, shape in (extra or {}).items()},
        generator=generator, emit_carry=torch.zeros((), device=device))


def step_pool(pool: ParticlePool, dt: float, emit_rate: float,
              emit_fn: Callable, sim_fn: Callable,
              max_emit_per_step: int = 64, draws=None) -> ParticlePool:
    """One emit and simulate tick.  `emit_fn(generator, K, draws)` returns
    (K, ...) fields 'position', 'velocity', 'lifetime' and any extra
    channels (K = max_emit_per_step), of which the first `floor(emit_rate
    * dt + carry)` spawn into dead slots; `sim_fn(pool, dt)` returns the
    updated fields of the whole pool, applied to live particles."""
    k = max_emit_per_step
    age = pool.age + dt
    alive = pool.alive & (age < pool.lifetime)

    want = emit_rate * dt + pool.emit_carry
    n_emit = torch.clamp(torch.floor(want), max=k)
    emit_carry = want - n_emit

    slots = torch.argsort(alive.to(torch.uint8), stable=True)[:k]
    slot_ok = (torch.arange(k, device=alive.device) < n_emit) & ~alive[slots]

    fields = emit_fn(pool.generator, k, draws)

    def put(cur, new):
        ok = slot_ok.reshape((-1,) + (1,) * (cur.dim() - 1))
        out = cur.clone()
        out[slots] = torch.where(ok, new, cur[slots])
        return out

    position = put(pool.position, fields["position"])
    velocity = put(pool.velocity, fields["velocity"])
    lifetime = put(pool.lifetime, fields["lifetime"])
    age = put(age, torch.zeros_like(fields["lifetime"]))
    alive = alive.clone()
    alive[slots] = slot_ok | alive[slots]
    data = {name: put(v, fields[name]) if name in fields else v
            for name, v in pool.data.items()}
    pool = pool.replace(position=position, velocity=velocity, age=age,
                        lifetime=lifetime, alive=alive, data=data,
                        emit_carry=emit_carry)

    updates = sim_fn(pool, dt)
    mask = pool.alive
    new = {name: torch.where(mask[:, None], updates[name],
                             getattr(pool, name))
           for name in ("position", "velocity") if name in updates}
    data = dict(pool.data)
    for name, v in updates.items():
        if name in data:
            mm = mask.reshape((-1,) + (1,) * (v.dim() - 1))
            data[name] = torch.where(mm, v, data[name])
    return pool.replace(data=data, **new)
