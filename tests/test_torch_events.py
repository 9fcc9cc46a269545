"""The port's force fields, triggers, collision events and ray pokes
(physics/events.py) and `physics_step(collect_events=True)` against the
JAX package on the CPU.  Each JAX function runs under its own jit.

Tolerances: masks and indices equal; forces and speeds within 1e-5; the
state after a step with force fields or events at pos / rot 5e-6, vel
5e-5, omega 5e-4 (the port's substep bars).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3d12renderer_tpu.physics import collide as jcollide
from d3d12renderer_tpu.physics import events as jevents
from d3d12renderer_tpu.physics import step as jstep
from d3d12renderer_tpu.physics import substep_pallas as jfused
from d3d12renderer_tpu.physics.builder import SceneBuilder as JaxSceneBuilder
from d3d12renderer_tpu.physics.types import PhysicsSettings as JaxSettings
from d3d12renderer_tpu_torch.convert import body_state_from_numpy
from d3d12renderer_tpu_torch.models import scenes
from d3d12renderer_tpu_torch.physics import collide, events, step, substep_cuda
from d3d12renderer_tpu_torch.physics.builder import SceneBuilder
from d3d12renderer_tpu_torch.physics.types import PhysicsSettings
from d3d12renderer_tpu_torch.terrain import heightmap as hm

torch.set_num_threads(1)

BODY_FIELDS = ("pos", "rot", "vel", "omega", "force", "torque")
STATE_TOL = (("pos", 5e-6), ("rot", 5e-6), ("vel", 5e-5), ("omega", 5e-4))
HEIGHTS = scenes.terrain_drop_heights()


def _fields_scene(b):
    """The showcase drop with two force fields (one holds the first two
    bodies, one pushes sideways) and two triggers."""
    scenes.add_terrain_drop(b, HEIGHTS)
    b.add_force_field((0.0, 3.0, 0.0), 5.0, (0.0, 30.0, 0.0))
    b.add_force_field((2.0, 4.0, -1.0), 3.0, (15.0, 0.0, -5.0))
    b.add_trigger((0.0, 2.0, 0.0), 4.0)
    b.add_trigger((-3.0, 3.0, 2.0), 2.5)


def _both(build):
    jb, tb = JaxSceneBuilder(), SceneBuilder()
    build(jb)
    build(tb)
    jarch, jstate = jb.finalize()
    tarch, _ = tb.finalize(device="cpu")
    return jarch, jstate, tarch


def _port(jstate):
    return body_state_from_numpy(
        {f: np.asarray(getattr(jstate, f))[None] for f in BODY_FIELDS},
        device="cpu")


def _near_ground(jstate, lift=0.3, seed=4):
    """Bodies `lift` above the bilinear surface, falling and turning."""
    rng = np.random.default_rng(seed)
    pos = np.asarray(jstate.pos).copy()
    y, _ = hm.sample_height_bilinear(
        torch.as_tensor(HEIGHTS), scenes.TERRAIN_DROP_ORIGIN,
        scenes.TERRAIN_DROP_CELL, torch.as_tensor(pos[:, 0]),
        torch.as_tensor(pos[:, 2]))
    pos[:, 1] = y.numpy() + lift
    vel = rng.normal(0, 0.3, pos.shape).astype(np.float32)
    vel[:, 1] = -2.0
    return jstate.replace(
        pos=jnp.asarray(pos), vel=jnp.asarray(vel),
        omega=jnp.asarray(rng.normal(0, 1.0, pos.shape).astype(np.float32)))


@pytest.fixture(scope="module")
def fields():
    return _both(_fields_scene)


def _scattered(jstate, seed):
    """Body centres spread over the fields' and triggers' spheres."""
    rng = np.random.default_rng(seed)
    n = np.asarray(jstate.pos).shape[0]
    pos = np.stack([rng.uniform(-4, 4, n), rng.uniform(0, 6, n),
                    rng.uniform(-3, 3, n)], -1).astype(np.float32)
    return jstate.replace(pos=jnp.asarray(pos))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_force_fields_match_jax(fields, seed):
    jarch, jstate, tarch = fields
    jstate = _scattered(jstate, seed)
    want = np.asarray(jax.jit(lambda s: jevents.apply_force_fields(
        jarch, s))(jstate))
    got = events.apply_force_fields(tarch, _port(jstate))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if seed == 0:
        assert np.abs(want).max() > 0


def test_triggers_match_jax(fields):
    """Inside, enter and leave over three poses, `inside` carried."""
    jarch, jstate, tarch = fields
    jprev = tprev = None
    seen = np.zeros(3, int)
    for seed in (5, 6, 7):
        s = _scattered(jstate, seed)
        want = jax.device_get(jax.jit(lambda s, p: jevents.evaluate_triggers(
            jarch, s, p))(s, jprev))
        got = events.evaluate_triggers(tarch, _port(s), tprev)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
        seen += [int(np.asarray(w).sum()) for w in want]
        jprev, tprev = want[0], got[0]
    assert (seen > 0).all()


def test_force_field_substep_matches_jax(fields):
    jarch, jstate, tarch = fields
    jstate = _near_ground(jstate)
    want, _ = jax.jit(lambda s: jstep.physics_substep(
        jarch, s, 1 / 120, JaxSettings(fused_substep="off",
                                       solver_backend="xla")))(jstate)
    got, _ = step.physics_substep(tarch, _port(jstate), 1 / 120,
                                  PhysicsSettings())
    for f, tol in STATE_TOL:
        np.testing.assert_allclose(getattr(got, f)[0].numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=tol, err_msg=f)


def test_collision_events_match_jax(fields):
    """On one contact table, with and without the lever arm, against a
    carried `prev_active`."""
    jarch, jstate, tarch = fields
    jstate = _near_ground(jstate, lift=0.25)
    jc = jax.jit(lambda s: jcollide.generate_contacts(jarch, s))(jstate)
    tc = collide.generate_contacts(tarch, _port(jstate))
    rng = np.random.default_rng(3)
    n = np.asarray(jstate.pos).shape[0]
    vel, omega, pos = (rng.normal(0, 1, (n + 1, 3)).astype(np.float32)
                       for _ in range(3))
    prev = rng.random(np.asarray(jc.active).shape) < 0.5
    for with_pos in (False, True):
        want = jax.device_get(jax.jit(
            lambda c, v, w, p, x: jevents.collision_events(
                c, v, w, p, pos=x if with_pos else None))(
                    jc, vel, omega, prev, pos))
        t = torch.as_tensor
        got = events.collision_events(tc, t(vel)[None], t(omega)[None],
                                      t(prev)[None],
                                      pos=t(pos)[None] if with_pos else None)
        for f in ("begin", "end", "active"):
            np.testing.assert_array_equal(getattr(got, f)[0].numpy(),
                                          np.asarray(getattr(want, f)))
        np.testing.assert_allclose(got.approach_speed[0].numpy(),
                                   np.asarray(want.approach_speed), rtol=0,
                                   atol=1e-5)
    assert np.asarray(want.active).any() and np.asarray(want.end).any()


def _events_scene(b):
    """The showcase heightmap with four spheres and a box falling onto it,
    the first two spheres about to meet (terrain and pair rows, A dynamic
    in the pair rows); no box pair, whose SAT takes XLA a minute to
    compile."""
    b.add_terrain(HEIGHTS, origin=scenes.TERRAIN_DROP_ORIGIN,
                  cell_size=scenes.TERRAIN_DROP_CELL, friction=0.7)
    for i, (x, z) in enumerate(((0.0, 0.0), (0.85, 0.1), (-3.0, 2.0),
                                (2.5, -3.0), (-1.5, -4.0))):
        body = b.add_body((x, 5.0, z))
        if i == 4:
            b.add_box_collider(body, (0.45, 0.45, 0.45), friction=0.7)
        else:
            b.add_sphere_collider(body, 0.45, friction=0.7)


def test_collect_events_over_two_frames_match_jax():
    """examples/showcase.py's `--audio` loop: two frames of 2 substeps with
    events, `prev_active` carried; the state, the last contacts and the
    folded events."""
    jarch, jstate, tarch = _both(_events_scene)
    jstate = _near_ground(jstate, lift=0.55)
    # The two spheres 0.85 apart close in on each other.
    jstate = jstate.replace(vel=jstate.vel.at[0, 0].set(1.0))
    settings_j, settings_t = JaxSettings(), PhysicsSettings()
    frame = jax.jit(lambda s, p: jstep.physics_step(
        jarch, s, settings_j, 1 / 60, num_substeps=2, collect_events=True,
        prev_active=p))
    tstate, jprev, tprev = _port(jstate), None, None
    began, fastest = 0, 0.0
    for _ in range(2):
        jstate, jc, jev = frame(jstate, jprev)
        tstate, tc, tev = step.physics_step(
            tarch, tstate, settings_t, 1 / 60, num_substeps=2,
            collect_events=True, prev_active=tprev)
        for f, tol in STATE_TOL:
            np.testing.assert_allclose(getattr(tstate, f)[0].numpy(),
                                       np.asarray(getattr(jstate, f)),
                                       rtol=0, atol=tol, err_msg=f)
        for f in ("begin", "end", "active"):
            np.testing.assert_array_equal(getattr(tev, f)[0].numpy(),
                                          np.asarray(getattr(jev, f)),
                                          err_msg=f)
        np.testing.assert_allclose(tev.approach_speed[0].numpy(),
                                   np.asarray(jev.approach_speed), rtol=0,
                                   atol=1e-4)
        np.testing.assert_array_equal(tc.active[0].numpy(),
                                      np.asarray(jc.active))
        began += int(np.asarray(jev.begin).sum())
        fastest = max(fastest, float(np.asarray(jev.approach_speed).max()))
        jprev, tprev = jev.active, tev.active
    assert began > 0 and fastest > 0.8


@pytest.mark.parametrize("exact", [False, True], ids=["bounds", "exact"])
def test_ray_poke_matches_jax(exact):
    """A poke straight down over each body, one over open terrain (a miss
    for the bounds, the terrain for the exact cast: no body pushed) and one
    at a slant through two bodies."""
    jarch, jstate, tarch = _both(
        lambda b: scenes.add_terrain_drop(b, HEIGHTS))
    pos = np.asarray(jstate.pos)
    rays = [((p[0] + 0.1, p[1] + 5.0, p[2] - 0.05), (0.0, -1.0, 0.0))
            for p in pos]
    rays.append(((20.0, 30.0, 20.0), (0.0, -1.0, 0.0)))
    d = pos[2] - pos[0]
    rays.append((tuple(pos[0] - 3 * d), tuple(d)))
    poke = jax.jit(lambda s, o, d: jevents.ray_poke(jarch, s, o, d, 500.0,
                                                   exact=exact))
    pushed = 0
    for o, d in rays:
        o = np.asarray(o, np.float32)
        d = np.asarray(d, np.float32)
        want = poke(jstate, o, d)
        got = events.ray_poke(tarch, _port(jstate), torch.as_tensor(o),
                              torch.as_tensor(d), 500.0, exact=exact)
        for f in ("force", "torque"):
            np.testing.assert_allclose(getattr(got, f)[0].numpy(),
                                       np.asarray(getattr(want, f)), rtol=0,
                                       atol=2e-3, err_msg=f)
        pushed += int(np.abs(np.asarray(want.force)).sum() > 0)
    assert pushed == len(pos) + 1


def test_ray_poke_per_scene():
    """Each scene pokes with its own ray: scene k pushes body k."""
    b = SceneBuilder()
    scenes.add_terrain_drop(b, HEIGHTS)
    arch, state = b.finalize(device="cpu")
    n = state.pos.shape[1]
    batch = state.replace(**{f: getattr(state, f).expand(
        (n,) + getattr(state, f).shape[1:]).clone() for f in BODY_FIELDS})
    origin = batch.pos[0] + torch.tensor([0.0, 5.0, 0.0])
    down = torch.tensor([0.0, -1.0, 0.0]).expand(n, 3)
    for exact in (False, True):
        out = events.ray_poke(arch, batch, origin, down, exact=exact)
        pushed = out.force.abs().sum(-1) > 0
        assert torch.equal(pushed, torch.eye(n, dtype=torch.bool))


def test_fused_route_refuses_force_fields():
    """support_reason refuses force fields, as JAX's does, on a scene the
    fused kernel takes without them."""
    def build(b, field):
        scenes.add_cloth_colliders(b)
        if field:
            b.add_force_field((0.0, 1.0, 0.0), 2.0, (0.0, 5.0, 0.0))

    for field, reason in ((False, None), (True, "force fields")):
        jb, tb = JaxSceneBuilder(), SceneBuilder()
        build(jb, field)
        build(tb, field)
        assert jfused.support_reason(jb.finalize()[0], JaxSettings()) == reason
        assert substep_cuda.support_reason(tb.finalize(device="cpu")[0],
                                           PhysicsSettings()) == reason
