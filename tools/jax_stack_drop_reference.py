"""The JAX package's own behaviour on BASELINE config 1 (the 1k-body stack
drop), the reference for the port's chip check of it, and the port's
runtime_gs from the same state.

Builds `models/scenes.add_stack_drop_1k` (1,000 bodies, the seed-0 jitter)
with the JAX builder and `STACK_DROP_1K_FINALIZE`, steps one scene for
FRAMES frames of 1/60 s (120 Hz, 30 iterations, split_jacobi) under
`jax.jit` on the CPU, and prints one JSON line every EVERY frames: the
overflow count of the sweep window alone (`sap_row_cap=0`), the whole
count (window and row cap), the lowest height and the largest |pos|.
Then, on the pile at rest: the active rows and the rows that the runtime
coloring leaves in its last, unguaranteed color for 32 (the default), 64
and 128 colors; GS_FRAMES frames of runtime_gs from that state with 32
colors in the JAX package, and in the port (on the CPU, from the same
state) with 32 and with 128 colors: the lowest and mean height after each
frame.  (JAX's runtime_gs with 128 colors is left out: XLA compiles its
128 unrolled color sweeps for over 15 minutes and 16 GB.)

    JAX_PLATFORMS=cpu python3 tools/jax_stack_drop_reference.py

About 5 minutes on one CPU.
"""

from __future__ import annotations

import json
import os
import sys
import time

FRAMES = 300
EVERY = 25
GS_FRAMES = 3


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import jax
    import jax.numpy as jnp

    from d3d12renderer_tpu.physics import broadphase, collide, solver
    from d3d12renderer_tpu.physics.builder import SceneBuilder
    from d3d12renderer_tpu.physics.step import physics_step
    from d3d12renderer_tpu.physics.types import PhysicsSettings
    from d3d12renderer_tpu_torch.models import scenes

    b = SceneBuilder()
    scenes.add_stack_drop_1k(b, 1000)
    arch, state = b.finalize(**scenes.STACK_DROP_1K_FINALIZE)
    no_cap = arch.replace(sap_row_cap=0)

    def settings(mode, colors=32):
        return PhysicsSettings(frame_rate=120, solver_iterations=30,
                               contact_mode=mode, runtime_gs_colors=colors)

    def emit(**kw):
        print(json.dumps(dict(kw, device=jax.devices()[0].platform)),
              flush=True)

    step = jax.jit(lambda s: physics_step(arch, s, settings("split_jacobi"),
                                          1 / 60.0)[0])
    counts = jax.jit(lambda s: (broadphase.overflow_count(no_cap, s),
                                broadphase.overflow_count(arch, s)))
    t0 = time.perf_counter()
    for frame in range(1, FRAMES + 1):
        state = step(state)
        if frame % EVERY == 0:
            spill, total = counts(state)
            emit(frame=frame, sweep_overflow=int(spill),
                 overflow_with_row_cap=int(total),
                 min_height=float(state.pos[:, 1].min()),
                 max_abs_pos=float(jnp.abs(state.pos).max()),
                 seconds=round(time.perf_counter() - t0, 1))

    def leftover(s, colors):
        ct = broadphase.compact_active(collide.generate_contacts(arch, s),
                                       arch.sap_active_budget)
        _, left = solver.runtime_color(
            ct.body_a, ct.body_b, ct.active, arch.inv_mass[ct.body_a] > 0,
            arch.inv_mass[ct.body_b] > 0, arch.num_bodies + 1, colors)
        return jnp.sum(ct.active), left

    for colors in (32, 64, 128):
        active, left = jax.jit(lambda s, c=colors: leftover(s, c))(state)
        emit(at_rest_active_rows=int(active), runtime_gs_colors=colors,
             rows_in_last_color=int(left))
    gs = jax.jit(lambda s: physics_step(arch, s, settings("runtime_gs"),
                                        1 / 60.0)[0])
    s = state
    for frame in range(1, GS_FRAMES + 1):
        s = gs(s)
        emit(package="jax", runtime_gs_colors=32, gs_frame=frame,
             min_height=float(s.pos[:, 1].min()),
             mean_height=float(s.pos[:, 1].mean()),
             split_jacobi_mean_height=float(state.pos[:, 1].mean()))

    import numpy as np
    import torch

    from d3d12renderer_tpu_torch.convert import body_state_from_numpy
    from d3d12renderer_tpu_torch.physics.builder import (
        SceneBuilder as PortBuilder)
    from d3d12renderer_tpu_torch.physics.step import (
        physics_step as port_step)
    from d3d12renderer_tpu_torch.physics.types import (
        PhysicsSettings as PortSettings)

    pb = PortBuilder()
    scenes.add_stack_drop_1k(pb, 1000)
    parch, _ = pb.finalize(device="cpu", **scenes.STACK_DROP_1K_FINALIZE)
    rest = body_state_from_numpy(
        {f: np.asarray(getattr(state, f))[None] for f in
         ("pos", "rot", "vel", "omega", "force", "torque")}, device="cpu")
    with torch.inference_mode():
        for colors in (32, 128):
            ps = PortSettings(frame_rate=120, solver_iterations=30,
                              contact_mode="runtime_gs",
                              runtime_gs_colors=colors)
            s = rest
            for frame in range(1, GS_FRAMES + 1):
                s, _ = port_step(parch, s, ps, 1 / 60.0)
                emit(package="port", runtime_gs_colors=colors,
                     gs_frame=frame,
                     min_height=float(s.pos[..., 1].min()),
                     mean_height=float(s.pos[..., 1].mean()))


if __name__ == "__main__":
    main()
