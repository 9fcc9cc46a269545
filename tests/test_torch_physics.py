"""The port's physics (d3d12renderer_tpu_torch.physics) against the JAX
package on the CPU: narrowphase, contact and joint prep, the plain colored
solve and one whole substep of the ragdoll archetype.

Both sides get the same numpy inputs from a seed: batch 4 of the locomotion
ragdoll lowered onto the ground plane.  Scene 0 keeps the standing pose, so
its feet rest flat and their bottom corners tie exactly in depth; scenes 1-3
are disturbed (position, rotation, velocity noise) and carry random motor
targets.  The JAX side runs the unfused XLA path (fused_substep="off",
solver_backend="xla"), which `test_solver_pallas.py` holds equal to the
Pallas solver kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3d12renderer_tpu.learning.loco_env import LocoEnv as JaxLocoEnv
from d3d12renderer_tpu.physics import collide as jcollide
from d3d12renderer_tpu.physics import joints as jjoints
from d3d12renderer_tpu.physics import narrow as jnarrow
from d3d12renderer_tpu.physics import solver as jsolver
from d3d12renderer_tpu.physics import solver_pallas as jsolver_pallas
from d3d12renderer_tpu.physics import step as jstep
from d3d12renderer_tpu.physics.types import BodyState as JaxBodyState
from d3d12renderer_tpu.physics.types import PhysicsSettings as JaxSettings
from d3d12renderer_tpu_torch.convert import body_state_from_numpy
from d3d12renderer_tpu_torch.learning.loco_env import LocoEnv
from d3d12renderer_tpu_torch.physics import narrow, solver_cuda, step
from d3d12renderer_tpu_torch.physics.types import PhysicsSettings

torch.set_num_threads(1)

B = 4
DT = 1.0 / 60.0
ITERATIONS = 30
JAX_SETTINGS = JaxSettings(frame_rate=60, fused_substep="off",
                           solver_backend="xla")
FIELDS = ("pos", "rot", "vel", "omega", "force", "torque")


def _inputs(state0):
    rng = np.random.default_rng(0)
    s = {f: np.repeat(np.asarray(getattr(state0, f))[None], B, 0)
         .astype(np.float32) for f in FIELDS}
    s["pos"] = s["pos"] + np.float32([0.0, -0.125, 0.0])
    noisy = slice(1, B)
    s["pos"][noisy] += rng.normal(0, 0.01, s["pos"][noisy].shape)
    q = s["rot"][noisy] + rng.normal(0, 0.05, s["rot"][noisy].shape)
    s["rot"][noisy] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    s["vel"][noisy] = rng.uniform(-0.5, 0.5, s["vel"][noisy].shape)
    s["omega"][noisy] = rng.uniform(-1.0, 1.0, s["omega"][noisy].shape)
    action = np.zeros((B, 27), np.float32)
    action[noisy] = rng.uniform(-1.5, 1.5, (B - 1, 27))
    return {k: v.astype(np.float32) for k, v in s.items()}, action


@pytest.fixture(scope="module")
def both():
    """JAX and port results on the same inputs, computed once."""
    jenv = JaxLocoEnv(settings=JAX_SETTINGS)
    tenv = LocoEnv()
    state_np, action_np = _inputs(jenv._state0)
    arch = jenv.arch
    num_pairs = int(arch.vs_plane_collider.shape[0])
    jsolve = jsolver_pallas.make_colored_solver(arch, num_pairs, ITERATIONS,
                                                "xla")

    def jax_prep_and_solve(state, action):
        contacts = jcollide.generate_contacts(arch, state)
        vel, omega, ii_w = jstep.integrate_forces(
            arch, state.pos, state.rot, state.vel, state.omega, state.force,
            state.torque, DT, JAX_SETTINGS.global_force_field)
        pos1 = jstep._append_world(state.pos)
        vel1, omega1 = jstep._append_world(vel), jstep._append_world(omega)
        ii_w1 = jnp.concatenate([ii_w, jnp.zeros((1, 3, 3))], 0)
        cprep = jsolver.prep_contacts_full(contacts, pos1, arch.inv_mass, ii_w1,
                                           vel1, omega1, DT)
        rot1 = jnp.concatenate([state.rot, jnp.array([[0.0, 0.0, 0.0, 1.0]])])
        ctx = jjoints.JointContext(pos1=pos1, rot1=rot1, inv_mass1=arch.inv_mass,
                                   ii_w1=ii_w1, local_cog1=arch.local_cog, dt=DT)
        jpreps = jjoints.prep_all(arch, ctx, jenv._motor_overrides(action))
        v, w = jsolve(jpreps, cprep, vel1, omega1)
        return contacts, cprep, jpreps, vel1, omega1, v, w

    def jax_substep(state, action):
        return jstep.physics_substep(arch, state, DT, JAX_SETTINGS,
                                     jenv._motor_overrides(action),
                                     allow_fused=False)[0]

    jstate = JaxBodyState(**{k: jnp.asarray(v) for k, v in state_np.items()})
    jaction = jnp.asarray(action_np)
    jout = jax.jit(jax.vmap(jax_prep_and_solve))(jstate, jaction)
    jsub = jax.jit(jax.vmap(jax_substep))(jstate, jaction)

    tstate = body_state_from_numpy(state_np)
    taction = torch.as_tensor(action_np)
    with torch.no_grad():
        sp = step.substep_prep(tenv.arch, tstate, DT, tenv.settings,
                               tenv._motor_overrides(taction))
        solve = solver_cuda.make_colored_solver(
            tenv.arch, num_pairs, ITERATIONS, "plain")
        tv, tw = solve(sp.joint_preps, sp.contact_prep, sp.vel1, sp.omega1)
        tsub, _ = step.physics_substep(tenv.arch, tstate, DT, tenv.settings,
                                       tenv._motor_overrides(taction))
    return dict(jax=jout, jax_substep=jsub, port=sp, port_solve=(tv, tw),
                port_substep=tsub, env=tenv)


def _close(got, want, atol, what, rtol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=what)


@pytest.mark.parametrize("field,atol", [
    ("normal", 1e-6), ("point", 1e-6), ("depth", 1e-6), ("pmask", None),
    ("friction", 1e-6), ("restitution", 1e-6), ("active", None),
])
def test_narrowphase_matches_jax(both, field, atol):
    got = getattr(both["port"].contacts, field)
    want = getattr(both["jax"][0], field)
    _close(got, want, atol, field)


def test_flat_box_corners_tie_break(both):
    """Scene 0's feet rest flat: the four bottom corners tie exactly in
    depth, and both packages keep the lowest corner indices (0, 1, 4, 5) in
    that order, which is the order their manifold points are solved in."""
    ct = both["port"].contacts
    arch = both["env"].arch
    (stype, s, e), = [seg for seg in arch.vs_plane_segments if seg[0] == 2]
    depth = ct.depth[0, s:e]
    assert torch.all(ct.pmask[0, s:e])
    assert torch.all(depth == depth[:, :1])            # exact ties
    score = torch.tensor([[0.3, 0.1, 0.0, 0.3, 0.3, 0.1, 0.3, 0.2]])
    _, idx = narrow.top_k(score, 4)
    _, jidx = jnarrow.jax_top_k(jnp.asarray(score.numpy()), 4)
    assert idx.tolist() == [[0, 3, 4, 6]] == np.asarray(jidx).tolist()
    corners = narrow.box_corners(torch.zeros(1, 3), torch.tensor([[0.0, 0, 0, 1]]),
                                 torch.ones(1, 3))
    _, _, hit = narrow.points_vs_plane(corners, torch.tensor([[0.0, 1, 0]]),
                                       torch.tensor([-0.5]))
    pts, _, _ = narrow.box_vs_plane(torch.zeros(1, 3),
                                    torch.tensor([[0.0, 0, 0, 1]]),
                                    torch.ones(1, 3), torch.tensor([[0.0, 1, 0]]),
                                    torch.tensor([-0.5]))
    assert hit[0].tolist() == [True, True, False, False, True, True, False, False]
    np.testing.assert_array_equal(pts[0, :, [0, 2]].numpy(),
                                  [[-1, -1], [1, -1], [-1, 1], [1, 1]])


@pytest.mark.parametrize("field", [
    "r_a", "r_b", "normal", "tangent", "bias", "eff_mass_n", "eff_mass_t",
    "n_to_wa", "n_to_wb", "t_to_wa", "t_to_wb", "inv_mass_a", "inv_mass_b",
    "friction", "pmask",
])
def test_contact_prep_matches_jax(both, field):
    """1e-5 absolute, and relative for the large impulse maps (|x| ~ 200)."""
    got = getattr(both["port"].contact_prep, field)
    want = getattr(both["jax"][1], field)
    if field in ("inv_mass_a", "inv_mass_b"):
        want = np.broadcast_to(np.asarray(want), got.shape)
    _close(got, want, 1e-5, field, rtol=1e-6)


# The swing axis of a cone-twist row is v / |v| of a near-identity swing
# quaternion: below ~1e-3 rad its direction is rounding noise in both
# packages, and it is read only once the swing limit is active.
_SWING_AXIS_FIELDS = ("swing_axis", "sw_to_wa", "sw_to_wb")


@pytest.mark.parametrize("kind", ["hinge", "cone_twist"])
def test_joint_prep_matches_jax(both, kind):
    """Every prep field within 1e-5 of the field's scale (max(1, max|x|)):
    the world inverse inertia (|x| ~ 30) rounds differently through the
    matrix products."""
    env = both["env"]
    k = [t.kind for t in env.arch.joints].index(kind)
    got, want = both["port"].joint_preps[k], both["jax"][2][k]
    assert set(got) == set(want)
    for name in sorted(got):
        g, w = got[name], want[name]
        if name in ("ia", "ib"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w)[0])
            continue
        if isinstance(g, tuple):
            g, w = torch.stack(g, -1), np.stack([np.asarray(x) for x in w], -1)
        g = g.to(torch.float32).numpy()
        w = np.asarray(w, np.float32)
        if name in _SWING_AXIS_FIELDS:
            defined = np.asarray(want["swing_angle"]) > 1e-3
            assert defined.sum() >= 6, defined
            g, w = g[defined], w[defined]
        _close(g, w, 1e-5 * max(1.0, float(np.abs(w).max())), f"{kind}.{name}")


def test_plain_colored_solve_matches_jax(both):
    vel1, omega1, v, w = both["jax"][3:7]
    _close(both["port"].vel1, vel1, 1e-6, "vel1 after forces")
    _close(both["port"].omega1, omega1, 1e-6, "omega1 after forces")
    tv, tw = both["port_solve"]
    _close(tv, v, 5e-5, "solved vel")
    _close(tw, w, 5e-5, "solved omega")


@pytest.mark.parametrize("field,atol", [
    ("pos", 5e-6), ("rot", 5e-6), ("vel", 5e-5), ("omega", 5e-4),
    ("force", 0.0), ("torque", 0.0),
])
def test_substep_matches_jax(both, field, atol):
    """One 30-iteration substep, tolerances of test_fused_substep.py."""
    _close(getattr(both["port_substep"], field),
           getattr(both["jax_substep"], field), atol, field)


@pytest.mark.parametrize("settings,error", [
    (PhysicsSettings(frame_rate=60, contact_mode="runtime_gs"),     # fused auto
     NotImplementedError),
    (PhysicsSettings(frame_rate=60, fused_substep="force",
                     contact_mode="split_jacobi"), NotImplementedError),
    (PhysicsSettings(frame_rate=60, fused_substep="off",
                     contact_mode="split_jacobi"), NotImplementedError),
    (PhysicsSettings(frame_rate=60, fused_substep="off",
                     solver_backend="xla"), ValueError),
])
def test_unported_settings_raise(both, settings, error):
    env = both["env"]
    with pytest.raises(error):
        step.physics_step(env.arch, env._state0, settings, DT)
