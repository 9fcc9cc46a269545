"""Collider-pair contacts and slider joints of the port against the JAX
package on the CPU: the six pair functions of `physics/narrow.py`, the
archetypes of the self-colliding ragdoll, the slider zoo and the stack drop
(pair buckets, tether pruning, global colors), slider prep and solve, the
plain colored solve and one env step of the self-colliding ragdoll, and a
few steps of the slider zoo.

Inputs come from numpy seeds and go to both packages.  The JAX side runs the
unfused XLA path (fused_substep="off", solver_backend="xla").
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
from d3d12renderer_tpu.physics.builder import SceneBuilder as JaxBuilder
from d3d12renderer_tpu.physics.types import BodyState as JaxBodyState
from d3d12renderer_tpu.physics.types import PhysicsSettings as JaxSettings
from d3d12renderer_tpu_torch.convert import (archetype_to_numpy,
                                             body_state_from_numpy)
from d3d12renderer_tpu_torch.learning.loco_env import LocoEnv
from d3d12renderer_tpu_torch.models import ragdoll as rd
from d3d12renderer_tpu_torch.models import scenes
from d3d12renderer_tpu_torch.physics import joints, narrow, solver_cuda, step
from d3d12renderer_tpu_torch.physics.builder import SceneBuilder
from d3d12renderer_tpu_torch.physics.types import PhysicsSettings

torch.set_num_threads(1)

B = 4
DT = 1.0 / 60.0
ITERATIONS = 30
JAX_SETTINGS = JaxSettings(frame_rate=60, fused_substep="off",
                           solver_backend="xla")
SETTINGS = PhysicsSettings(frame_rate=60)
FIELDS = ("pos", "rot", "vel", "omega", "force", "torque")


def _close(got, want, atol, what, rtol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=what)


# --------------------------------------------------------------------------
# The six pair functions at seeded generic poses
# --------------------------------------------------------------------------

N_PAIRS = 512


def _centers(rng):
    return rng.uniform(-0.7, 0.7, (N_PAIRS, 3))


def _radii(rng):
    return rng.uniform(0.15, 0.5, N_PAIRS)


def _quats(rng):
    q = rng.normal(size=(N_PAIRS, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _halves(rng):
    return rng.uniform(0.15, 0.5, (N_PAIRS, 3))


def _segment(rng):
    c = _centers(rng)
    d = rng.normal(size=(N_PAIRS, 3))
    d *= rng.uniform(0.1, 0.5, (N_PAIRS, 1)) / np.linalg.norm(d, axis=-1,
                                                                keepdims=True)
    return c - d, c + d


PAIR_INPUTS = {
    "sphere_vs_sphere": lambda r: (_centers(r), _radii(r), _centers(r),
                                   _radii(r)),
    "sphere_vs_capsule": lambda r: (_centers(r), _radii(r), *_segment(r),
                                    _radii(r)),
    "capsule_vs_capsule": lambda r: (*_segment(r), _radii(r), *_segment(r),
                                     _radii(r)),
    "sphere_vs_box": lambda r: (_centers(r), _radii(r), _centers(r),
                                _quats(r), _halves(r)),
    "capsule_vs_box": lambda r: (*_segment(r), _radii(r), _centers(r),
                                 _quats(r), _halves(r)),
    "box_vs_box": lambda r: (_centers(r), _quats(r), _halves(r),
                             _centers(r), _quats(r), _halves(r)),
}


@pytest.mark.parametrize("name", sorted(PAIR_INPUTS))
def test_pair_function_matches_jax(name):
    """Normals, points and depths within 1e-5 on the pairs that touch,
    masks equal on all; a good share of the pairs touch.  The poses are
    generic: no parallel segments, no tied separating axes."""
    args = [a.astype(np.float32)
            for a in PAIR_INPUTS[name](np.random.default_rng(11))]
    want = getattr(jnarrow, name)(*(jnp.asarray(a) for a in args))
    got = getattr(narrow, name)(*(torch.as_tensor(a) for a in args))
    for g, w, what in zip(got, want, ("normal", "point", "depth", "mask")):
        assert g.shape == w.shape, (what, g.shape, w.shape)
    mask = np.asarray(want[3])
    np.testing.assert_array_equal(got[3].numpy(), mask)
    touching = mask.any(axis=-1)
    assert touching.sum() >= N_PAIRS // 8, touching.sum()
    for g, w, what in zip(got[:3], want[:3], ("normal", "point", "depth")):
        _close(g[torch.as_tensor(touching)], np.asarray(w)[touching], 1e-5,
               f"{name} {what}")


def test_parallel_segments_take_jax_tie_rule():
    """Parallel segments (denominator 0) take s = 0 and the t it gives (s
    again where that t clamps), in both packages: the named tie of
    `closest_points_segment_segment`.  In row 1 the second segment covers
    the first one's start, so s stays 0."""
    p1 = np.float32([[0, 0, 0], [0, 0, 0], [1, 2, 3]])
    q1 = np.float32([[1, 0, 0], [2, 0, 0], [1, 2, 4]])
    p2 = np.float32([[0.5, 0.3, 0], [-1, 0.2, 0], [1.5, 2, 3.5]])
    q2 = np.float32([[2.5, 0.3, 0], [3, 0.2, 0], [1.5, 2, 5]])
    want = jnarrow.closest_points_segment_segment(
        *(jnp.asarray(a) for a in (p1, q1, p2, q2)))
    got = narrow.closest_points_segment_segment(
        *(torch.as_tensor(a) for a in (p1, q1, p2, q2)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[0][1].numpy(), p1[1])


# --------------------------------------------------------------------------
# Archetypes
# --------------------------------------------------------------------------

def _finalize_both(add):
    jb, tb = JaxBuilder(), SceneBuilder()
    add(jb)
    add(tb)
    jarch, jstate = jb.finalize()
    tarch, tstate = tb.finalize(device="cpu")
    return jarch, jstate, tarch, tstate


def _self_colliding(b):
    b.add_static_plane((0.0, 1.0, 0.0), 0.0, friction=1.0, restitution=0.1)
    rd.build_humanoid_ragdoll(b, hip_position=(0.0, 1.25, 0.0),
                              self_collision=True)


SCENES = {"self_collision": _self_colliding,
          "slider_zoo": scenes.add_slider_zoo,
          "stack_drop": scenes.add_stack_drop}


def _assert_archetypes_equal(got_arch, want_arch):
    """Every array of the port's archetype: ints and colors exact, floats
    within 1e-6."""
    want = archetype_to_numpy(want_arch)
    got = archetype_to_numpy(got_arch)
    assert set(got) == set(want)
    for name in sorted(want):
        g, w = got[name], want[name]
        assert g.shape == w.shape and g.dtype.kind == w.dtype.kind, name
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_archetype_matches_jax(name):
    jarch, jstate, tarch, tstate = _finalize_both(SCENES[name])
    _assert_archetypes_equal(tarch, jarch)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tstate, f)[0].numpy(),
                                   np.asarray(getattr(jstate, f)), atol=1e-6)
    rows = {(b.type_a, b.type_b): b.collider_a.shape[0]
            for b in tarch.contact_buckets}
    if name == "self_collision":
        # 75 capsule-capsule, 26 capsule-box and 1 box-box rows after
        # tether pruning, 36 colors over plane and pair rows.
        assert rows == {(1, 1): 75, (1, 2): 26, (2, 2): 1}
        assert tarch.vs_plane_num_colors == len(
            tarch.contact_color_indices) == 36
        assert tarch.num_contact_rows == 17 + 102
    elif name == "slider_zoo":
        assert set(rows) == {(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)}
        assert [t.kind for t in tarch.joints] == [
            "ball", "distance", "fixed", "hinge", "slider"]
    else:
        assert rows == {(0, 2): 3, (2, 2): 3}


def _hinged_wheels(b):
    """A chassis on four hinged wheels and a ball-jointed chain of three
    spheres: wheels far apart along the chassis are pruned by the hinge
    bound, the chain's far links by the chained ball bound."""
    b.add_static_plane((0.0, 1.0, 0.0), 0.0)
    chassis = b.add_body((0.0, 1.0, 0.0))
    b.add_box_collider(chassis, (2.5, 0.2, 0.5))
    for x in (-2.0, 2.0):
        for z in (-0.7, 0.7):
            wheel = b.add_body((x, 0.6, z))
            b.add_sphere_collider(wheel, 0.4)
            b.add_hinge_joint(chassis, wheel, (x, 0.6, z), (0.0, 0.0, 1.0))
    prev = chassis
    for i in range(3):
        link = b.add_body((3.0 + 0.9 * i, 1.0, 0.0))
        b.add_sphere_collider(link, 0.3)
        b.add_ball_joint(prev, link, (2.55 + 0.9 * i, 1.0, 0.0))
        prev = link


def test_tethers_prune_pairs_as_jax():
    """The same (collider, collider) pairs survive tether pruning in both
    builders, and the archetypes agree."""
    jb, tb = JaxBuilder(), SceneBuilder()
    for b in (jb, tb):
        _hinged_wheels(b)
    jarch, _ = jb.finalize()
    tarch, _ = tb.finalize(device="cpu")
    _assert_archetypes_equal(tarch, jarch)
    jbr = np.asarray(jarch.col_bound_radius)
    tbr = tarch.col_bound_radius.numpy()
    jt, tt = jb._compute_tethers(jbr), tb._compute_tethers()
    c = len(tb.colliders)
    pairs = [(i, j) for i in range(c) for j in range(i + 1, c)]
    pruned = [p for p in pairs if tb._tether_pruned(*p, tt, tbr)]
    assert pruned == [p for p in pairs if jb._tether_pruned(*p, jt, jbr)]
    assert 0 < len(pruned) < len(pairs)


# --------------------------------------------------------------------------
# Self-colliding ragdoll: posed into contact
# --------------------------------------------------------------------------

def _posed_inputs(state0, part_idx):
    """B ragdolls lowered onto the ground with their limbs drawn in toward
    the torso (60% of their horizontal offset, the feet and toes 30%), so
    that capsule-capsule, capsule-box and box-box rows touch; rotations and
    positions jittered off the symmetric pose, velocities and motor targets
    random."""
    rng = np.random.default_rng(5)
    s = {f: np.repeat(np.asarray(getattr(state0, f))[None], B, 0)
         .astype(np.float64) for f in FIELDS}
    idx = {n: int(i) for n, i in zip(rd.BODY_PARTS, part_idx)}
    torso = idx["torso"]
    shrink = np.full((1, s["pos"].shape[1], 1), 0.6)
    shrink[:, [idx[n] for n in ("left_foot", "right_foot", "left_toes",
                               "right_toes")]] = 0.3
    c = s["pos"][:, torso:torso + 1, :]
    s["pos"][..., [0, 2]] = (c[..., [0, 2]]
                             + shrink * (s["pos"][..., [0, 2]] - c[..., [0, 2]]))
    s["pos"] += np.array([0.0, -0.125, 0.0])
    s["pos"] += rng.normal(0, 0.01, s["pos"].shape)
    q = s["rot"] + rng.normal(0, 0.05, s["rot"].shape)
    s["rot"] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    s["vel"] = rng.uniform(-0.5, 0.5, s["vel"].shape)
    s["omega"] = rng.uniform(-1.0, 1.0, s["omega"].shape)
    action = rng.uniform(-1.0, 1.0, (B, 27))
    return ({k: v.astype(np.float32) for k, v in s.items()},
            action.astype(np.float32))


@pytest.fixture(scope="module")
def ragdolls():
    """JAX and port results on the posed self-colliding ragdolls: contacts,
    preps and the plain colored solve, and one env step (`_step_core`)."""
    jenv = JaxLocoEnv(settings=JAX_SETTINGS, self_collision=True)
    tenv = LocoEnv(self_collision=True, device="cpu")
    state_np, action_np = _posed_inputs(jenv._state0,
                                        np.asarray(jenv.part_idx))
    arch = jenv.arch
    num_pairs = tenv.arch.num_contact_rows
    jsolve = jsolver_pallas.make_colored_solver(arch, num_pairs, ITERATIONS,
                                                "xla")

    def jax_all(state, action):
        contacts = jcollide.generate_contacts(arch, state)
        vel, omega, ii_w = jstep.integrate_forces(
            arch, state.pos, state.rot, state.vel, state.omega, state.force,
            state.torque, DT, JAX_SETTINGS.global_force_field)
        pos1 = jstep._append_world(state.pos)
        vel1, omega1 = jstep._append_world(vel), jstep._append_world(omega)
        ii_w1 = jnp.concatenate([ii_w, jnp.zeros((1, 3, 3))], 0)
        cprep = jsolver.prep_contacts_full(contacts, pos1, arch.inv_mass,
                                           ii_w1, vel1, omega1, DT)
        rot1 = jnp.concatenate([state.rot, jnp.array([[0.0, 0.0, 0.0, 1.0]])])
        ctx = jjoints.JointContext(pos1=pos1, rot1=rot1,
                                   inv_mass1=arch.inv_mass, ii_w1=ii_w1,
                                   local_cog1=arch.local_cog, dt=DT)
        jpreps = jjoints.prep_all(arch, ctx, jenv._motor_overrides(action))
        v, w = jsolve(jpreps, cprep, vel1, omega1)
        core = jenv._step_core(state, action)
        return contacts, cprep, v, w, core

    jstate = JaxBodyState(**{k: jnp.asarray(v) for k, v in state_np.items()})
    jout = jax.jit(jax.vmap(jax_all))(jstate, jnp.asarray(action_np))

    tstate = body_state_from_numpy(state_np, device="cpu")
    taction = torch.as_tensor(action_np)
    with torch.no_grad():
        sp = step.substep_prep(tenv.arch, tstate, DT, tenv.settings,
                               tenv._motor_overrides(taction))
        solve = solver_cuda.make_colored_solver(
            tenv.arch, num_pairs, ITERATIONS, "plain")
        tv, tw = solve(sp.joint_preps, sp.contact_prep, sp.vel1, sp.omega1)
        core = tenv._step_core(tstate, taction)
    return dict(jax=jout, port=sp, port_solve=(tv, tw), port_core=core,
                env=tenv)


def test_posed_ragdolls_have_active_pair_rows(ragdolls):
    """Every scene has active pair rows, and each bucket has some."""
    ct = ragdolls["port"].contacts
    arch = ragdolls["env"].arch
    q = arch.vs_plane_collider.shape[0]
    assert torch.all(ct.active[:, q:].sum(1) >= 3)
    start = q
    for bucket in arch.contact_buckets:
        end = start + bucket.collider_a.shape[0]
        assert ct.active[:, start:end].any(), (bucket.type_a, bucket.type_b)
        start = end


@pytest.mark.parametrize("field,atol", [
    ("normal", 1e-5), ("point", 1e-5), ("depth", 1e-5), ("pmask", None),
    ("friction", 1e-6), ("restitution", 1e-6), ("active", None),
])
def test_self_colliding_contacts_match_jax(ragdolls, field, atol):
    """The whole table, plane rows then buckets.  Points and depths of
    masked-off manifold points are compared too."""
    _close(getattr(ragdolls["port"].contacts, field),
           getattr(ragdolls["jax"][0], field), atol, field)


@pytest.mark.parametrize("field", [
    "r_a", "r_b", "normal", "tangent", "bias", "eff_mass_n", "eff_mass_t",
    "n_to_wa", "n_to_wb", "t_to_wa", "t_to_wb", "inv_mass_a", "inv_mass_b",
    "friction", "pmask",
])
def test_self_colliding_contact_prep_matches_jax(ragdolls, field):
    """Every field within 1e-5 of its scale (max(1, max|x|)): the impulse
    maps multiply the world inverse inertia of the light parts (|x| up to
    ~1700 for the toes) by lever arms, and cancel to values of ~1, so they
    round differently in the two packages' matrix products."""
    got = getattr(ragdolls["port"].contact_prep, field)
    want = np.asarray(getattr(ragdolls["jax"][1], field))
    if field in ("inv_mass_a", "inv_mass_b"):
        want = np.broadcast_to(want, got.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.dtype != bool else 0
    _close(got, want, 1e-5 * scale, field)


def test_self_colliding_plain_solve_matches_jax(ragdolls):
    """The plain colored solve (one table of plane and pair rows in the
    global color order) against JAX's make_colored_solver(..., "xla")."""
    tv, tw = ragdolls["port_solve"]
    _close(tv, ragdolls["jax"][2], 5e-5, "solved vel")
    _close(tw, ragdolls["jax"][3], 5e-5, "solved omega")


@pytest.mark.parametrize("field,atol", [
    ("pos", 5e-6), ("rot", 5e-6), ("vel", 5e-5), ("omega", 5e-4),
    ("force", 0.0), ("torque", 0.0),
])
def test_self_colliding_env_step_matches_jax(ragdolls, field, atol):
    """One env step (`_step_core`: one 30-iteration substep, then fall
    check and auto-reset), at the bars of the plane-only ragdoll."""
    got = ragdolls["port_core"][0]
    want = ragdolls["jax"][4][0]
    _close(getattr(got, field), getattr(want, field), atol, field)


def test_self_colliding_obs_reward_match_jax(ragdolls):
    _, obs, reward, done = ragdolls["port_core"]
    _, jobs, jreward, jdone = ragdolls["jax"][4]
    _close(done, jdone, None, "done")
    _close(obs, jobs, 5e-5, "obs")
    _close(reward, jreward, 5e-5, "reward")


def test_self_colliding_env_takes_the_unfused_route():
    """The fused kernel refuses pair buckets: even fused_substep="force"
    builds no fused route, so the env steps through the colored solve."""
    env = LocoEnv(settings=PhysicsSettings(frame_rate=60,
                                           fused_substep="force"),
                  self_collision=True, device="cpu")
    assert env._fused_step is None


# --------------------------------------------------------------------------
# Sliders: prep, solve and a few steps of the zoo
# --------------------------------------------------------------------------

def _zoo_inputs(state0, info, batch=B, seed=9):
    """Zoo scenes with the carriage pushed past either limit (+-0.35 along
    the axis) and off the axis, jittered poses and random velocities."""
    rng = np.random.default_rng(seed)
    s = {f: np.repeat(getattr(state0, f).numpy(), batch, 0)
         .astype(np.float64) for f in FIELDS}
    car = info["carriage"]
    s["pos"][:, car, 0] += np.where(np.arange(batch) % 2 == 0, 0.35, -0.35)
    s["pos"][:, car] += rng.normal(0, 0.01, (batch, 3))
    free = np.array([b for b in range(s["pos"].shape[1]) if b != info["anchor"]])
    s["pos"][:, free] += rng.normal(0, 0.003, (batch, len(free), 3))
    q = s["rot"][:, free] + rng.normal(0, 0.02, (batch, len(free), 4))
    s["rot"][:, free] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    s["vel"][:, free] = rng.uniform(-0.3, 0.3, (batch, len(free), 3))
    s["omega"][:, free] = rng.uniform(-0.5, 0.5, (batch, len(free), 3))
    return {k: v.astype(np.float32) for k, v in s.items()}


@pytest.fixture(scope="module")
def zoo():
    jb, tb = JaxBuilder(), SceneBuilder()
    scenes.add_slider_zoo(jb)
    info = scenes.add_slider_zoo(tb)
    jarch, jstate0 = jb.finalize()
    tarch, tstate0 = tb.finalize(device="cpu")
    return jarch, tarch, info, _zoo_inputs(tstate0, info)


def _slider_preps(jarch, tarch, state_np):
    """JAX's and the port's slider prep on the same states."""
    k = [t.kind for t in tarch.joints].index("slider")
    jstate = JaxBodyState(**{f: jnp.asarray(v) for f, v in state_np.items()})

    def jprep(state):
        rot1 = jnp.concatenate([state.rot, jnp.array([[0.0, 0.0, 0.0, 1.0]])])
        _, _, ii_w = jstep.integrate_forces(
            jarch, state.pos, state.rot, state.vel, state.omega, state.force,
            state.torque, DT, (0.0, 0.0, 0.0))
        ii_w1 = jnp.concatenate([ii_w, jnp.zeros((1, 3, 3))], 0)
        ctx = jjoints.JointContext(
            pos1=jstep._append_world(state.pos), rot1=rot1,
            inv_mass1=jarch.inv_mass, ii_w1=ii_w1, local_cog1=jarch.local_cog,
            dt=DT)
        return jjoints.prep_all(jarch, ctx)[k]

    want = jax.jit(jax.vmap(jprep))(jstate)
    tstate = body_state_from_numpy(state_np, device="cpu")
    with torch.no_grad():
        got = step.substep_prep(tarch, tstate, DT, SETTINGS).joint_preps[k]
    return got, want


def test_slider_prep_matches_jax(zoo):
    """Every field within 1e-5 of its scale; the limit is active in every
    scene, below it in half and above it in the other half."""
    jarch, tarch, _, state_np = zoo
    got, want = _slider_preps(jarch, tarch, state_np)
    assert set(got) == set(want)
    for name in sorted(got):
        g, w = got[name], want[name]
        if name in ("ia", "ib"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w)[0])
            continue
        if isinstance(g, tuple):
            g, w = torch.stack(g, -1), np.stack([np.asarray(x) for x in w], -1)
        g, w = g.to(torch.float32).numpy(), np.asarray(w, np.float32)
        _close(g, w, 1e-5 * max(1.0, float(np.abs(w).max())), name)
    assert np.all(np.asarray(want["eff_limit"]) > 0)
    assert sorted(np.asarray(want["limit_sign"])[:, 0].tolist()) == [
        -1.0, -1.0, 1.0, 1.0]


def test_slider_solve_matches_jax(zoo):
    """Three sweeps of the slider row solve from random velocities and
    impulses: velocities and impulses within 1e-5 of their scale."""
    jarch, tarch, _, state_np = zoo
    got_prep, want_prep = _slider_preps(jarch, tarch, state_np)
    rng = np.random.default_rng(4)
    vels = [rng.uniform(-1, 1, (B, 1, 3)).astype(np.float32) for _ in range(4)]
    imp = rng.uniform(0.0, 0.2, (B, 1, 2)).astype(np.float32)

    def jsolve(prep, va, wa, vb, wb, imp):
        for _ in range(3):
            va, wa, vb, wb, imp = jjoints._solve_slider(prep, va, wa, vb, wb,
                                                        imp)
        return va, wa, vb, wb, imp

    want = jax.vmap(jsolve)(want_prep, *(jnp.asarray(v) for v in vels),
                            jnp.asarray(imp))
    p = {k: v for k, v in got_prep.items() if k not in joints.DROP_FIELDS}
    va, wa, vb, wb = (torch.as_tensor(v) for v in vels)
    timp = torch.as_tensor(imp).clone()
    for _ in range(3):
        va, wa, vb, wb = joints._solve_slider(p, va, wa, vb, wb, timp)
    for g, w, what in zip((va, wa, vb, wb, timp), want,
                          ("va", "wa", "vb", "wb", "imp")):
        w = np.asarray(w)
        _close(g, w, 1e-5 * max(1.0, float(np.abs(w).max())), what)


ZOO_STEPS = 5


def test_slider_zoo_steps_match_jax(zoo):
    """5 steps of 2 zoo scenes, every body field within BASELINE's 1e-3."""
    jarch, tarch, _, state_np = zoo
    state_np = {k: v[:2] for k, v in state_np.items()}
    jsub = jax.jit(jax.vmap(lambda s: jstep.physics_substep(
        jarch, s, DT, JAX_SETTINGS, None, allow_fused=False)[0]))
    js = JaxBodyState(**{f: jnp.asarray(v) for f, v in state_np.items()})
    ts = body_state_from_numpy(state_np, device="cpu")
    active = 0
    with torch.no_grad():
        for _ in range(ZOO_STEPS):
            js = jsub(js)
            ts, contacts = step.physics_step(tarch, ts, SETTINGS, DT)
            active += int(contacts.active[:, tarch.vs_plane_collider.shape[0]:]
                          .sum())
    assert active > 0
    for f in ("pos", "rot", "vel", "omega"):
        _close(getattr(ts, f), getattr(js, f), 1e-3, f)
