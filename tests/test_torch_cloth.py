"""The port's cloth (physics/cloth.py) and its coupling to rigid bodies
(physics/cloth_coupling.py) against the JAX package on the CPU:
`create_cloth`, `simulate` with velocity, position and drift iterations,
`apply_wind`, both collide functions, `cloth_triangle_indices`, and
`step_cloth_with_bodies` after `physics_step` over 5 frames at 9 x 9 and
17 x 17, the cloth draped on the rigid sphere and capsule, the port's
archetype converted from JAX's (`convert.archetype_from_numpy`) and equal
to its own builder's.  Each JAX function runs under its own jit.

Tolerances: the cloth's arrays equal at creation; positions within 1e-5
and velocities within 1e-3 after the steps compared (a velocity is a
position difference over dt = 1/120: 1e-5 / dt ~ 1e-3); the bodies'
state at pos / rot 5e-6, vel 5e-5, omega 5e-4.  The 12-color solve is the
JAX package's (a documented divergence from the reference's sequential
order, ROADMAP.md Queue 3).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3d12renderer_tpu.physics import cloth as jcl
from d3d12renderer_tpu.physics import cloth_coupling as jcc
from d3d12renderer_tpu.physics import step as jstep
from d3d12renderer_tpu.physics.builder import SceneBuilder as JaxSceneBuilder
from d3d12renderer_tpu.physics.types import PhysicsSettings as JaxSettings
from d3d12renderer_tpu_torch.convert import (archetype_from_numpy,
                                             archetype_to_numpy,
                                             body_state_from_numpy)
from d3d12renderer_tpu_torch.models import scenes
from d3d12renderer_tpu_torch.physics import cloth as cl
from d3d12renderer_tpu_torch.physics import cloth_coupling as cc
from d3d12renderer_tpu_torch.physics import step
from d3d12renderer_tpu_torch.physics.builder import SceneBuilder
from d3d12renderer_tpu_torch.physics.types import PhysicsSettings

torch.set_num_threads(1)

DT = scenes.CLOTH_DT
POS_TOL, VEL_TOL = 1e-5, 1e-3
BODY_FIELDS = ("pos", "rot", "vel", "omega", "force", "torque")
CLOTH_FIELDS = ("positions", "prev_positions", "velocities", "forces")


def _to_port(state):
    return cl.ClothState(*(torch.as_tensor(np.array(getattr(state, f)))
                           for f in CLOTH_FIELDS))


def _check(got, want, pos_tol=POS_TOL, vel_tol=VEL_TOL):
    for f, tol in (("positions", pos_tol), ("prev_positions", pos_tol),
                   ("velocities", vel_tol), ("forces", pos_tol)):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=tol, err_msg=f)


@pytest.mark.parametrize("args", [
    (1.0, 1.0, 9, 9, 1.0, {}),
    (2.0, 1.5, 12, 7, 0.5, dict(stiffness=0.9, damping=3.0,
                                gravity_factor=0.5, fix_top_row=False)),
], ids=["square", "ragged"])
def test_create_cloth_matches_jax(args):
    *pos, kw = args
    jp, js = jcl.create_cloth(*pos, **kw)
    tp, ts = cl.create_cloth(*pos, **kw, device="cpu")
    np.testing.assert_array_equal(tp.inv_mass.numpy(), np.asarray(jp.inv_mass))
    for f in CLOTH_FIELDS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))
    for f in ("stiffness", "damping", "gravity_factor", "width", "height"):
        assert getattr(tp, f) == getattr(jp, f), f


@pytest.mark.parametrize("iters", [(0, 1, 0), (2, 3, 0), (1, 2, 2)],
                         ids=["defaults", "velocity", "drift"])
def test_simulate_matches_jax(iters):
    """30 steps of a hanging 9 x 9 cloth in the velocity / position / drift
    iteration counts given, with wind every step."""
    vi, pi, di = iters
    jp, js = jcl.create_cloth(1.0, 1.0, 9, 9, total_mass=1.0, stiffness=0.7,
                              damping=0.5)
    tp, ts = cl.create_cloth(1.0, 1.0, 9, 9, total_mass=1.0, stiffness=0.7,
                             damping=0.5, device="cpu")
    wind = (0.0, 1.0, 6.0)

    @jax.jit
    def jsim(s):
        s = jcl.apply_wind(s, jnp.array(wind))
        return jcl.simulate(jp, s, DT, vi, pi, di)

    for _ in range(30):
        js = jsim(js)
        ts = cl.simulate(tp, cl.apply_wind(ts, wind), DT, vi, pi, di)
    _check(ts, js)
    assert np.asarray(js.positions)[-1, :, 1].mean() < -0.01


def test_apply_wind_matches_jax():
    """On a crumpled cloth: every corner's share of its quads' forces."""
    rng = np.random.default_rng(1)
    _, js = jcl.create_cloth(1.0, 1.0, 8, 11, total_mass=1.0)
    pos = (np.asarray(js.positions)
           + rng.normal(0, 0.05, np.shape(js.positions))).astype(np.float32)
    js = js.replace(positions=jnp.asarray(pos))
    force = np.array([3.0, -1.0, 7.0], np.float32)
    want = jax.jit(jcl.apply_wind)(js, force)
    got = cl.apply_wind(_to_port(js), torch.as_tensor(force))
    np.testing.assert_allclose(got.forces.numpy(), np.asarray(want.forces),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("margin", [0.0, 0.01])
def test_collide_functions_match_jax(margin):
    """Particles in and around two spheres and two capsules, with leading
    scene axes (2 scenes)."""
    rng = np.random.default_rng(2)
    pts = rng.uniform(-0.7, 0.7, (2, 9, 9, 3)).astype(np.float32)
    centers = rng.uniform(-0.5, 0.5, (2, 2, 3)).astype(np.float32)
    radii = rng.uniform(0.2, 0.5, 2).astype(np.float32)
    p0 = rng.uniform(-0.8, 0.8, (2, 2, 3)).astype(np.float32)
    p1 = (p0 + rng.uniform(-0.5, 0.5, (2, 2, 3))).astype(np.float32)
    t = torch.as_tensor
    want = jax.jit(jax.vmap(partial(jcl.collide_spheres, margin=margin),
                            in_axes=(0, 0, None)))(pts, centers, radii)
    got = cl.collide_spheres(t(pts), t(centers), t(radii), margin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert (np.abs(np.asarray(want) - pts).max(-1) > 0).mean() > 0.05
    want = jax.jit(jax.vmap(partial(jcl.collide_capsules, margin=margin),
                            in_axes=(0, 0, 0, None)))(pts, p0, p1, radii)
    got = cl.collide_capsules(t(pts), t(p0), t(p1), t(radii), margin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert (np.abs(np.asarray(want) - pts).max(-1) > 0).mean() > 0.05


@pytest.mark.parametrize("shape", [(2, 2), (5, 3), (17, 17)])
def test_cloth_triangle_indices_match_jax(shape):
    np.testing.assert_array_equal(cl.cloth_triangle_indices(*shape),
                                  jcl.cloth_triangle_indices(*shape))


def _jax_collide_fn(jarch, jbody, margin):
    """The JAX package's sphere and capsule projections, each collider
    type with its own radii (`jcc.make_rigid_collide_fn` rebinds `radii`
    before its sphere closure runs, so there the spheres take the
    capsules' radii: test_jax_collide_fn_gives_spheres_capsule_radii)."""
    from d3d12renderer_tpu.core import maths as jm
    from d3d12renderer_tpu.physics.collide import collider_world_poses

    wpos, wrot = collider_world_poses(jarch, jbody)
    col_type = np.asarray(jarch.col_type)
    si, ci = np.nonzero(col_type == 0)[0], np.nonzero(col_type == 1)[0]
    axis = jm.quat_rotate(wrot[ci], jnp.broadcast_to(jnp.array(
        [0.0, 1.0, 0.0]), wpos[ci].shape))
    half = jarch.col_size[ci, 1][:, None]

    def collide(p):
        p = jcl.collide_spheres(p, wpos[si], jarch.col_size[si, 0], margin)
        return jcl.collide_capsules(p, wpos[ci] - axis * half,
                                    wpos[ci] + axis * half,
                                    jarch.col_size[ci, 0], margin)

    return collide


def _sphere_only(b):
    """tests/test_cloth.py:98-104's scene: the rolling sphere alone."""
    b.add_static_plane((0, 1, 0), -3.0)
    ball = b.add_body(position=(-2.0, -0.8, -0.5), gravity_factor=0.0,
                      linear_damping=0.0)
    b.add_sphere_collider(ball, radius=scenes.CLOTH_BALL_RADIUS)
    return {"ball": ball}


def _cloth_scene(grid, capsule):
    build = scenes.add_cloth_colliders if capsule else _sphere_only
    jb, tb = JaxSceneBuilder(), SceneBuilder()
    info = build(jb)
    build(tb)
    jarch, jbody = jb.finalize()
    flat = archetype_to_numpy(jarch)
    built = archetype_to_numpy(tb.finalize(device="cpu")[0])
    assert set(built) == set(flat)
    for name in flat:
        np.testing.assert_allclose(built[name], flat[name], rtol=0, atol=1e-6,
                                   err_msg=name)
    tarch = archetype_from_numpy(flat, device="cpu")
    jbody = jbody.replace(vel=jbody.vel.at[info["ball"]].set(
        jnp.array(scenes.CLOTH_BALL_VEL)))
    jp, jcs = jcl.create_cloth(scenes.CLOTH_SIZE, scenes.CLOTH_SIZE, grid,
                               grid, total_mass=scenes.CLOTH_MASS,
                               damping=scenes.CLOTH_DAMPING)
    tp, _ = cl.create_cloth(scenes.CLOTH_SIZE, scenes.CLOTH_SIZE, grid, grid,
                            total_mass=scenes.CLOTH_MASS,
                            damping=scenes.CLOTH_DAMPING, device="cpu")
    return jarch, jbody, jp, jcs, tarch, tp


@pytest.mark.parametrize("capsule", [False, True],
                         ids=["sphere", "sphere_capsule"])
@pytest.mark.parametrize("grid", [9, 17])
def test_step_cloth_with_bodies_matches_jax(grid, capsule):
    """tests/test_cloth.py's coupled frame (physics_step, then
    step_cloth_with_bodies), 5 frames from the state JAX reaches after 60
    frames, when the cloth drapes over the colliders; the collide function
    moves particles in each compared frame.  With the sphere alone JAX's
    own `step_cloth_with_bodies` is the reference; with the capsule too,
    JAX's `simulate` with its collide functions at each type's radii."""
    jarch, jbody, jp, jcs, tarch, tp = _cloth_scene(grid, capsule)
    settings = JaxSettings()

    @jax.jit
    def jframe(cs, bs):
        bs, _ = jstep.physics_step(jarch, bs, settings, DT)
        if not capsule:
            return jcc.step_cloth_with_bodies(
                jp, cs, jarch, bs, DT, scenes.CLOTH_ITERATIONS,
                scenes.CLOTH_MARGIN), bs
        return jcl.simulate(
            jp, cs, DT, position_iterations=scenes.CLOTH_ITERATIONS,
            collide_fn=_jax_collide_fn(jarch, bs, scenes.CLOTH_MARGIN)), bs

    for _ in range(60):
        jcs, jbody = jframe(jcs, jbody)
    tcs = cl.ClothState(*(torch.as_tensor(np.array(getattr(jcs, f)))[None]
                          for f in CLOTH_FIELDS))
    tbody = body_state_from_numpy(
        {f: np.asarray(getattr(jbody, f))[None] for f in BODY_FIELDS},
        device="cpu")
    for _ in range(5):
        jcs, jbody = jframe(jcs, jbody)
        tbody, _ = step.physics_step(tarch, tbody, PhysicsSettings(), DT)
        fn = cc.make_rigid_collide_fn(tarch, tbody, scenes.CLOTH_MARGIN)
        pos = cl.simulate(tp, tcs, DT, position_iterations=1).positions
        assert bool((fn(pos) != pos).any())
        tcs = cc.step_cloth_with_bodies(tp, tcs, tarch, tbody, DT,
                                        scenes.CLOTH_ITERATIONS,
                                        scenes.CLOTH_MARGIN)
        for f in ("pos", "rot"):
            np.testing.assert_allclose(getattr(tbody, f)[0].numpy(),
                                       np.asarray(getattr(jbody, f)), rtol=0,
                                       atol=5e-6, err_msg=f)
        _check(cl.ClothState(*(getattr(tcs, f)[0] for f in CLOTH_FIELDS)),
               jcs)


def test_jax_collide_fn_gives_spheres_capsule_radii():
    """The reference-side hazard the port does not copy: with a sphere
    (r 0.4) and a capsule (r 0.15), JAX's `make_rigid_collide_fn` projects
    the particles out of the sphere at the capsule's radius; the port's
    uses each collider's own."""
    jarch, jbody, _, _, tarch, _ = _cloth_scene(9, True)
    rng = np.random.default_rng(4)
    ball = np.asarray(jbody.pos)[0]
    pts = (ball + rng.uniform(-0.45, 0.45, (9, 9, 3))).astype(np.float32)
    jax_fn = jcc.make_rigid_collide_fn(jarch, jbody, 0.0)(jnp.asarray(pts))
    right = _jax_collide_fn(jarch, jbody, 0.0)(jnp.asarray(pts))
    tbody = body_state_from_numpy(
        {f: np.asarray(getattr(jbody, f))[None] for f in BODY_FIELDS},
        device="cpu")
    port = cc.make_rigid_collide_fn(tarch, tbody, 0.0)(
        torch.as_tensor(pts)[None])[0].numpy()
    np.testing.assert_allclose(port, np.asarray(right), rtol=0, atol=1e-5)
    gap = np.linalg.norm(np.asarray(jax_fn) - ball, axis=-1).min()
    assert 0.1 < gap < 0.4 - 0.05
    assert np.linalg.norm(port - ball, axis=-1).min() > 0.4 - 1e-5


def test_rigid_collide_fn_needs_spheres_or_capsules():
    b = SceneBuilder()
    b.add_static_plane((0.0, 1.0, 0.0), 0.0)
    b.add_box_collider(b.add_body((0.0, 1.0, 0.0)), (0.5, 0.5, 0.5))
    arch, state = b.finalize(device="cpu")
    assert cc.make_rigid_collide_fn(arch, state) is None
