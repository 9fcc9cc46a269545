"""The port's step variants against the JAX package on the CPU:
`physics_step_interpolated` (the carried accumulator, the substep count,
the render pose between the last two substeps, the frame-drop guard) and
`make_batched_step`.  Each JAX function runs under its own jit.

Tolerances: the accumulator and substep count exact (Python floats on
both sides); poses at pos / rot 5e-6, vel 5e-5, omega 5e-4 (the port's
substep bars); the render pose within 5e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3d12renderer_tpu.physics import step as jstep
from d3d12renderer_tpu.physics.builder import SceneBuilder as JaxSceneBuilder
from d3d12renderer_tpu.physics.types import PhysicsSettings as JaxSettings
from d3d12renderer_tpu_torch.convert import body_state_from_numpy
from d3d12renderer_tpu_torch.physics import step
from d3d12renderer_tpu_torch.physics.builder import SceneBuilder
from d3d12renderer_tpu_torch.physics.types import PhysicsSettings

torch.set_num_threads(1)

BODY_FIELDS = ("pos", "rot", "vel", "omega", "force", "torque")
STATE_TOL = (("pos", 5e-6), ("rot", 5e-6), ("vel", 5e-5), ("omega", 5e-4))


def _spheres(b):
    """Three spheres and a capsule falling onto a plane, the lowest sphere
    touching it, the others in contact (plane and pair rows)."""
    b.add_static_plane((0.0, 1.0, 0.0), 0.0, friction=0.8)
    for i, y in enumerate((0.39, 1.17, 1.95)):
        b.add_sphere_collider(b.add_body((0.1 * i, y, 0.0)), 0.4,
                              restitution=0.2)
    b.add_capsule_collider(b.add_body((0.7, 0.49, 0.1)), 0.2, 0.3)


@pytest.fixture(scope="module")
def stack():
    """`_spheres`, the bodies moving and turning.  (At rest the touching
    spheres' normal relative velocity is zero up to rounding, and its sign
    switches the Baumgarte bias on or off: a knife edge in both
    packages.)"""
    jb, tb = JaxSceneBuilder(), SceneBuilder()
    _spheres(jb)
    _spheres(tb)
    jarch, jstate = jb.finalize()
    tarch, _ = tb.finalize(device="cpu")
    rng = np.random.default_rng(0)
    shape = np.shape(jstate.omega)
    jstate = jstate.replace(
        vel=jnp.asarray(rng.normal(0, 0.5, shape).astype(np.float32)),
        omega=jnp.asarray(rng.normal(0, 2, shape).astype(np.float32)))
    return jarch, jstate, tarch


def _port(jstate):
    return body_state_from_numpy(
        {f: np.asarray(getattr(jstate, f))[None] for f in BODY_FIELDS},
        device="cpu")


def _check_state(got, want):
    for f, tol in STATE_TOL:
        np.testing.assert_allclose(getattr(got, f)[0].numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=tol, err_msg=f)


# (frame dt, carried accumulator): 120 Hz physics at a 60 Hz frame, at a
# 50 Hz frame with leftover time carried, a frame shorter than a substep,
# and a 0.2 s frame drop (capped at max_substeps, the fraction kept).
@pytest.mark.parametrize("dt,acc", [(1 / 60, 0.0), (1 / 50, 0.004),
                                    (1 / 200, 0.0), (0.2, 0.003)],
                         ids=["60hz", "50hz", "short", "drop"])
def test_interpolated_step_matches_jax(stack, dt, acc):
    jarch, jstate, tarch = stack
    settings_j = JaxSettings(fused_substep="off", solver_backend="xla")
    want = jax.jit(lambda s: jstep.physics_step_interpolated(
        jarch, s, settings_j, dt, acc))(jstate)
    jstate_new, _, j_acc, (j_rpos, j_rrot) = want
    got_state, _, t_acc, (t_rpos, t_rrot) = step.physics_step_interpolated(
        tarch, _port(jstate), PhysicsSettings(), dt, acc)
    # The accumulator and the substep count are host arithmetic.
    h = 1 / 120
    total = acc + dt
    n = int(total / h)
    if n > 4:
        n, total = 4, 4 * h + total % h
    assert t_acc == j_acc == pytest.approx(total - n * h, abs=0)
    assert 0.0 <= t_acc < h or n == 4
    _check_state(got_state, jstate_new)
    np.testing.assert_allclose(t_rpos[0].numpy(), np.asarray(j_rpos), rtol=0,
                               atol=5e-6)
    np.testing.assert_allclose(t_rrot[0].numpy(), np.asarray(j_rrot), rtol=0,
                               atol=5e-6)
    # The render pose lies between the last two substeps' poses.
    if n:
        prev, _ = step.physics_step(tarch, _port(jstate), PhysicsSettings(),
                                    (n - 1) * h, num_substeps=n - 1) \
            if n > 1 else (_port(jstate), None)
        alpha = t_acc / h
        lerp = prev.pos + (got_state.pos - prev.pos) * alpha
        np.testing.assert_allclose(t_rpos.numpy(), lerp.numpy(), rtol=0,
                                   atol=1e-6)


def test_interpolated_step_carries_the_accumulator(stack):
    """Three 50 Hz frames: 2, 2, then 3 substeps as the leftover time
    crosses a substep.  The port carries its accumulator as a Python float; JAX's
    comes back from its jit as float32, so JAX is given the port's."""
    jarch, jstate, tarch = stack
    settings_j = JaxSettings(fused_substep="off", solver_backend="xla")
    tstate, acc, counts = _port(jstate), 0.0, []

    def jframe(acc):
        return jax.jit(lambda s: jstep.physics_step_interpolated(
            jarch, s, settings_j, 1 / 50, acc))

    for _ in range(3):
        jstate, _, acc_j, _ = jframe(acc)(jstate)
        tstate, _, new_acc, _ = step.physics_step_interpolated(
            tarch, tstate, PhysicsSettings(), 1 / 50, acc)
        assert np.float32(new_acc) == np.asarray(acc_j)
        counts.append(round((acc + 1 / 50 - new_acc) * 120))
        acc = new_acc
    assert counts == [2, 2, 3]
    _check_state(tstate, jstate)


def test_make_batched_step_matches_jax(stack):
    """Three scenes of one archetype, each its own pose, one frame."""
    jarch, jstate, tarch = stack
    rng = np.random.default_rng(1)
    batch = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (3,) + x.shape), jstate)
    batch = batch.replace(pos=batch.pos + jnp.asarray(
        rng.normal(0, 0.01, np.shape(batch.pos)).astype(np.float32)))
    jfn = jstep.make_batched_step(
        jarch, JaxSettings(fused_substep="off", solver_backend="xla"), 1 / 60)
    want = jfn(batch)
    tfn = step.make_batched_step(tarch, PhysicsSettings(), 1 / 60)
    got = tfn(body_state_from_numpy(
        {f: np.asarray(getattr(batch, f)) for f in BODY_FIELDS},
        device="cpu"))
    for f, tol in STATE_TOL:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=tol, err_msg=f)
