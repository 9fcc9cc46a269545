"""The port's fused whole-substep route (physics/substep_cuda.py and
csrc/fused_substep.cu) against the JAX package on the CPU: its dispatch, its
archetype constants, its results, and the kernel source itself compiled as
host C++.  Also distance, ball and fixed joints (builder, prep, unfused
step) against JAX on a jointed chain.

JAX and torch draw different random numbers, so pokes come from the JAX env's
key stream and are injected into the port; actions come from a numpy seed.
Swing targets are kept at +-1 rad: near a reached swing target the
cone-twist position motor takes acos of a value within ulps of 1, which turns
one float32 ulp into ~3e-4 rad in either package.
"""

import ctypes
import dataclasses
import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3d12renderer_tpu.learning.loco_env import LocoEnv as JaxLocoEnv
from d3d12renderer_tpu.physics import joints as jjoints
from d3d12renderer_tpu.physics import step as jstep
from d3d12renderer_tpu.physics import substep_pallas
from d3d12renderer_tpu.physics.builder import SceneBuilder as JaxSceneBuilder
from d3d12renderer_tpu.physics.types import BodyState as JaxBodyState
from d3d12renderer_tpu.physics.types import PhysicsSettings as JaxSettings
from d3d12renderer_tpu_torch.convert import (
    archetype_to_numpy, body_state_from_numpy, env_state_from_numpy)
from d3d12renderer_tpu_torch.learning.loco_env import (
    ACTION_SIZE, NUM_PARTS, POKE_PROBABILITY, STATE_SIZE, LocoEnv)
from d3d12renderer_tpu_torch.physics import joints, solver_cuda, step
from d3d12renderer_tpu_torch.physics import substep_cuda
from d3d12renderer_tpu_torch.physics.builder import SceneBuilder
from d3d12renderer_tpu_torch.physics.types import PhysicsSettings

torch.set_num_threads(1)

DT = 1.0 / 60.0
FIELDS = ("pos", "rot", "vel", "omega", "force", "torque")
# One substep against JAX (tests/test_torch_physics.py::test_substep_matches_jax).
SUBSTEP_ATOL = dict(pos=5e-6, rot=5e-6, vel=5e-5, omega=5e-4, force=0.0,
                    torque=0.0)


def _build_chain(builder_cls):
    """A kinematic anchor and four bodies (sphere, box, sphere, box) lying
    on the ground plane, jointed distance -> ball -> fixed -> hinge.  All
    bodies share a no-collide group, so the only contacts are plane rows.
    A ball joint between the anchor and the world is inactive (both sides
    static): a hole in the ball table."""
    b = builder_cls()
    b.add_static_plane((0.0, 1.0, 0.0), 0.0, friction=0.9, restitution=0.2)
    group = b.new_no_collide_group()
    anchor = b.add_body((0.0, 1.2, 0.0), kinematic=True)
    b.set_no_collide_group(anchor, group)
    bodies = []
    for i in range(4):
        body = b.add_body((0.5 * (i + 1), 0.45 if i % 2 == 0 else 0.28, 0.0))
        if i % 2 == 0:
            b.add_sphere_collider(body, radius=0.5, friction=0.7)
        else:
            b.add_box_collider(body, (0.3, 0.3, 0.2), restitution=0.3)
        b.set_no_collide_group(body, group)
        bodies.append(body)
    b.add_distance_joint(anchor, bodies[0], (0.0, 1.2, 0.0), (0.5, 0.45, 0.0))
    b.add_ball_joint(bodies[0], bodies[1], (0.75, 0.4, 0.0))
    b.add_ball_joint(anchor, -1, (0.0, 1.2, 0.0))
    b.add_fixed_joint(bodies[1], bodies[2], (1.25, 0.35, 0.0))
    b.add_hinge_joint(bodies[2], bodies[3], (1.75, 0.35, 0.0), (0.0, 0.0, 1.0),
                      min_limit=-0.5, max_limit=0.5, motor_type=1.0,
                      motor_target=0.3, max_torque=50.0)
    return b.finalize()


def _chain_state(state0, batch=3, seed=0):
    """`batch` copies of the chain's start, disturbed from scene 1 on."""
    rng = np.random.default_rng(seed)
    s = {f: np.repeat(np.asarray(getattr(state0, f)).reshape(
        np.shape(getattr(state0, f))[-2:])[None], batch, 0).astype(np.float32)
        for f in FIELDS}
    s["vel"][1:] = rng.uniform(-0.5, 0.5, s["vel"][1:].shape)
    s["omega"][1:] = rng.uniform(-1.0, 1.0, s["omega"][1:].shape)
    s["vel"][:, 0] = s["omega"][:, 0] = 0.0           # the kinematic anchor
    return {k: v.astype(np.float32) for k, v in s.items()}


@pytest.fixture(scope="module")
def chains():
    jarch, jstate0 = _build_chain(JaxSceneBuilder)
    tarch, tstate0 = _build_chain(SceneBuilder)
    return jarch, jstate0, tarch, tstate0


@pytest.fixture(scope="module")
def loco():
    return (JaxLocoEnv(settings=JaxSettings(frame_rate=60)),
            LocoEnv(settings=PhysicsSettings(frame_rate=60)))


# --------------------------------------------------------------------------
# Dispatch
# --------------------------------------------------------------------------

def _port_slider(arch):
    """The archetype with its hinge table relabelled as a slider: the port's
    builder does not build sliders yet."""
    tables = tuple(dataclasses.replace(t, kind="slider") if t.kind == "hinge"
                   else t for t in arch.joints)
    return dataclasses.replace(arch, joints=tables, cache={})


def _jax_slider(arch):
    tables = tuple(t.replace(kind="slider") if t.kind == "hinge" else t
                   for t in arch.joints)
    return arch.replace(joints=tables)


@pytest.mark.parametrize("case", ["loco", "chain", "contact_mode", "backend",
                                  "slider"])
def test_support_reason_matches_jax(loco, chains, case):
    """The port's `solver_backend="plain"` stands where JAX has "xla"."""
    jenv, tenv = loco
    jarch, _, tarch, _ = chains
    jset, tset = JaxSettings(frame_rate=60), PhysicsSettings(frame_rate=60)
    if case == "loco":
        jarch, tarch = jenv.arch, tenv.arch
    elif case == "contact_mode":
        jset = JaxSettings(contact_mode="split_jacobi")
        tset = PhysicsSettings(contact_mode="split_jacobi")
    elif case == "backend":
        jset = JaxSettings(solver_backend="xla")
        tset = PhysicsSettings(solver_backend="plain")
    elif case == "slider":
        jarch, tarch = _jax_slider(jarch), _port_slider(tarch)
    want = substep_pallas.support_reason(jarch, jset)
    got = substep_cuda.support_reason(tarch, tset)
    if case == "backend":
        assert want == "solver_backend xla" and got == "solver_backend plain"
    else:
        assert got == want
    assert (got is None) == (case in ("loco", "chain"))


@pytest.mark.parametrize("mode,device,want", [
    ("off", "cpu", None), ("off", "cuda", None), ("auto", "cpu", None),
    ("auto", "cuda", "auto"), ("force", "cpu", "force"),
    ("force", "cuda", "force"),
])
def test_should_build(mode, device, want):
    assert substep_cuda.should_build(
        PhysicsSettings(fused_substep=mode), device) == want


def test_auto_on_cpu_takes_the_unfused_path(loco):
    """As JAX's "auto" off the TPU: no fused route, contacts come back."""
    _, tenv = loco
    assert substep_cuda.make_fused_substep(
        tenv.arch, tenv.settings, DT, None, "cpu") is None
    state, contacts = step.physics_step(tenv.arch, tenv._state0,
                                        tenv.settings, DT)
    assert contacts is not None
    assert tenv._fused_env_step() is None


def test_force_on_cpu_runs_the_plain_version(loco):
    """"force" on CPU tensors builds the fused route, which runs the unfused
    substep (bit for bit) and, as JAX's, returns no contacts."""
    _, tenv = loco
    force = PhysicsSettings(frame_rate=60, solver_iterations=4,
                            fused_substep="force")
    off = dataclasses.replace(force, fused_substep="off")
    before = substep_cuda.fused_substep_cuda.launches
    got, contacts = step.physics_substep(tenv.arch, tenv._state0, DT, force)
    want, want_contacts = step.physics_substep(tenv.arch, tenv._state0, DT, off)
    assert contacts is None and want_contacts is not None
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert substep_cuda.fused_substep_cuda.launches == before


@pytest.mark.parametrize("overrides,built", [
    (None, True),
    ("loco", True),
    ("stiffness", False),       # not a runtime motor target: no fused route
])
def test_override_keys_gate_the_route(loco, overrides, built):
    _, tenv = loco
    force = PhysicsSettings(frame_rate=60, fused_substep="force")
    mo = None
    if overrides == "loco":
        mo = tenv._motor_overrides(torch.zeros((2, ACTION_SIZE)))
    elif overrides == "stiffness":
        mo = (None, {"max_torque": torch.zeros((2, 6))})
    route = substep_cuda.make_fused_substep(tenv.arch, force, DT, mo, "cpu")
    assert (route is not None) == built
    assert substep_cuda.make_fused_substep(tenv.arch, force, 1e-6, mo,
                                           "cpu") is None    # dt gate


def test_fused_route_refuses_cpu_tensors_for_the_kernel(loco):
    _, tenv = loco
    consts = substep_cuda.pack_consts(tenv.arch, tenv.settings, DT,
                                      tenv._action_columns(), ACTION_SIZE,
                                      "cpu")
    state = tenv.reset(2, torch.Generator())[1].bodies
    with pytest.raises(ValueError, match="CUDA"):
        substep_cuda.fused_substep_cuda(state, torch.zeros((2, ACTION_SIZE)),
                                        consts, tenv.post_consts())


def test_launch_args_check_shapes(loco):
    _, tenv = loco
    consts = substep_cuda.pack_consts(tenv.arch, tenv.settings, DT,
                                      tenv._action_columns(), ACTION_SIZE,
                                      "cpu")
    state = tenv.reset(2, torch.Generator())[1].bodies
    with pytest.raises(ValueError, match="overrides"):
        substep_cuda.launch_args(state, torch.zeros((2, 5)), consts, None)
    with pytest.raises(ValueError, match="state.vel"):
        substep_cuda.launch_args(state.replace(vel=state.vel.double()),
                                 torch.zeros((2, ACTION_SIZE)), consts, None)
    args, keep, extras = substep_cuda.launch_args(
        state, torch.zeros((2, ACTION_SIZE)), consts, tenv.post_consts())
    assert extras.shape == (2, STATE_SIZE + 2)
    assert keep["prep"].shape == (consts.planes, 2)
    assert args.batch == 2 and args.num_bodies == NUM_PARTS
    assert args.num_impulses == 7 * 4 + 6 * 2 + 17 * 8


# --------------------------------------------------------------------------
# Archetype constants
# --------------------------------------------------------------------------

def _assert_same(got, want, what):
    if want is None or isinstance(want, (int, str)):
        assert got == want, what
    elif isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_same(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)) and want and isinstance(
            want[0], (dict, list, type(None))):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{what}[{i}]")
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), rtol=0,
                                   atol=1e-6, err_msg=what)


@pytest.mark.parametrize("which", ["loco", "chain"])
def test_extract_consts_matches_jax(loco, chains, which):
    """Body constants, plane rows (combined friction and restitution),
    contact colors, joint tables in solve order and their holes: floats
    within 1e-6 (the builders' float32 rounding), the rest exact."""
    if which == "loco":
        jarch, tarch = loco[0].arch, loco[1].arch
    else:
        jarch, _, tarch, _ = chains
    jbody, jrows, jcolors, jtables = substep_pallas._extract_consts(jarch)
    tbody, trows, tcolors, ttables = substep_cuda.extract_consts(tarch)
    _assert_same(tbody, {k: np.asarray(v) for k, v in jbody.items()}, "body")
    _assert_same(trows, jrows, "plane rows")
    assert tcolors == [list(c) for c in jcolors]
    assert [t["kind"] for t in ttables] == [t["kind"] for t in jtables]
    _assert_same(ttables, [dict(t, colors=[list(c) for c in t["colors"]])
                           for t in jtables], "tables")
    holes = [[r is None for r in t["rows"]] for t in jtables]
    if which == "chain":
        assert [t["kind"] for t in ttables] == ["distance", "ball", "fixed",
                                                "hinge"]
        assert holes[1] == [False, True]


@pytest.mark.parametrize("which", ["loco", "chain"])
def test_packed_rows_follow_the_solver_order(loco, chains, which):
    """Each packed row record carries its JAX row: active flags mark the
    holes, plane rows carry JAX's combined materials."""
    if which == "loco":
        jarch, tarch = loco[0].arch, loco[1].arch
    else:
        jarch, _, tarch, _ = chains
    _, jrows, _, jtables = substep_pallas._extract_consts(jarch)
    consts = substep_cuda.pack_consts(tarch, PhysicsSettings(), DT, {}, 0,
                                      "cpu")
    solver = solver_cuda.ColoredSolver(tarch, len(jrows), 30, "kernel")
    off = substep_cuda.const_offsets()
    by_arch = {t["arch_index"]: t for t in jtables}
    i = 0
    for m in solver.tables:
        for src in m.perm:
            rf, ri = consts.row_f[i].numpy(), consts.row_i[i].numpy()
            row = (jrows[src] if m.kind == "contact"
                   else by_arch[m.arch_index]["rows"][src])
            assert ri[off["R_ACTIVE"]] == (row is not None), (m.kind, src)
            if m.kind == "contact" and row is not None:
                assert ri[off["R_SHAPE"]] == row["type"]
                np.testing.assert_allclose(
                    rf[[off["P_FRICTION"], off["P_RESTITUTION"]]],
                    [row["friction"], row["restitution"]], rtol=0, atol=1e-7)
            elif row is not None:
                np.testing.assert_allclose(
                    rf[off["K_ANCHOR_A"]:off["K_ANCHOR_A"] + 3],
                    row["anchor_a"], rtol=0, atol=1e-6)
            i += 1
    assert i == consts.row_f.shape[0] == consts.row_i.shape[0]


def test_kernel_constants_match_the_wrapper():
    """The constants and the FusedArgs struct of fused_substep.cu are the
    wrapper's layout."""
    src = (solver_cuda.CSRC_DIR / "fused_substep.cu").read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int ([A-Z0-9_]+) = (\d+);", src)}
    for name, offset in substep_cuda.const_offsets().items():
        assert consts.get(name) == offset, name
    assert consts["MAX_BODIES"] == substep_cuda.MAX_BODIES
    body = re.search(r"struct FusedArgs \{(.*?)\n\};", src, re.S).group(1)
    members = re.findall(r"^\s+(?:const )?(\w+)\*? (\w+);", body, re.M)
    want = [name for name, _ in substep_cuda.FusedArgs._fields_]
    assert [name for _, name in members] == want
    kinds = {"float*": ctypes.c_void_p, "int*": ctypes.c_void_p,
             "int": ctypes.c_int, "float": ctypes.c_float}
    for (ctype, name), (_, ptype) in zip(
            re.findall(r"^\s+(?:const )?(\w+\*?) (\w+);", body, re.M),
            substep_cuda.FusedArgs._fields_):
        assert kinds[ctype] is ptype, name


# --------------------------------------------------------------------------
# The route against JAX
# --------------------------------------------------------------------------

def _jax_poke_draws(rng):
    """The (do, part, theta) that JAX's `LocoEnv.step` draws from `rng`
    (one env), and the key it carries on."""
    rng, poke_key = jax.random.split(rng)
    k1, k2, k3 = jax.random.split(poke_key, 3)
    do = jax.random.uniform(k1) < POKE_PROBABILITY
    part = jax.random.randint(k2, (), 0, NUM_PARTS)
    theta = jax.random.uniform(k3, minval=0.0, maxval=2.0 * jnp.pi)
    return rng, do, part, theta


def _rollouts(jax_fused, port_fused, batch, steps, iterations, seed):
    """Both envs from the same start with the same actions and pokes; the
    pokes come from the JAX key stream.  Returns per-step
    (obs, bodies, reward, done) of each side."""
    jenv = JaxLocoEnv(settings=JaxSettings(
        frame_rate=60, solver_iterations=iterations, fused_substep=jax_fused))
    tenv = LocoEnv(settings=PhysicsSettings(
        frame_rate=60, solver_iterations=iterations,
        fused_substep=port_fused))
    rng = np.random.default_rng(seed)
    actions = rng.uniform(-0.5, 0.5, (steps, batch, ACTION_SIZE))
    actions[..., 1:3 * 7:3] = np.where(
        rng.uniform(size=(steps, batch, 7)) < 0.5, -1.0, 1.0)
    actions = actions.astype(np.float32)

    keys = jax.random.split(jax.random.PRNGKey(seed), batch)
    _, jst = jax.jit(jax.vmap(jenv.reset))(keys)
    draws = jax.jit(jax.vmap(_jax_poke_draws))
    _, tst = tenv.reset(batch, torch.Generator().manual_seed(0))
    tst = env_state_from_numpy(
        {f: np.asarray(getattr(jst.bodies, f)) for f in FIELDS},
        np.asarray(jst.last_action), np.asarray(jst.steps), tst.generator)
    jstep_fn = jax.jit(jax.vmap(jenv.step))
    keys_now = jst.rng
    out = []
    with torch.no_grad():
        for t in range(steps):
            keys_now, do, part, theta = draws(keys_now)
            jobs, jst, jrew, jdone = jstep_fn(jst, jnp.asarray(actions[t]))
            tobs, tst, trew, tdone = tenv.step(
                tst, torch.as_tensor(actions[t]),
                poke=(torch.tensor(np.asarray(do)),
                      torch.tensor(np.asarray(part)).to(torch.int64),
                      torch.tensor(np.asarray(theta))))
            out.append(((jobs, jst.bodies, jrew, jdone),
                        (tobs, tst.bodies, trew, tdone)))
    return out, tenv


def _check_step(jax_out, port_out, atol):
    (jobs, jb, jrew, jdone), (tobs, tb, trew, tdone) = jax_out, port_out
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs),
                               atol=atol["obs"], rtol=0)
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew),
                               atol=atol["reward"], rtol=0)
    for f in ("pos", "rot", "vel", "omega"):
        if f in atol:
            np.testing.assert_allclose(getattr(tb, f).numpy(),
                                       np.asarray(getattr(jb, f)),
                                       atol=atol[f], rtol=0, err_msg=f)


@pytest.fixture(scope="module")
def force_vs_unfused():
    """The port's env with fused_substep="force" on CPU tensors (the fused
    route, running its plain version) against JAX's unfused XLA path: 4
    envs, 5 steps."""
    before = substep_cuda.fused_substep_cuda.launches
    out, tenv = _rollouts("off", "force", batch=4, steps=5, iterations=30,
                          seed=5)
    assert tenv._fused_step is not None
    assert substep_cuda.fused_substep_cuda.launches == before
    return out


@pytest.mark.parametrize("t", range(5))
def test_fused_route_on_cpu_matches_jax_unfused(force_vs_unfused, t):
    """Bounds of tests/test_torch_loco_env.py: done exact, obs 5e-5, reward
    1e-4, body poses within 1e-3."""
    _check_step(*force_vs_unfused[t],
                dict(obs=5e-5, reward=1e-4, pos=1e-3, rot=1e-3))


@pytest.mark.slow
def test_fused_route_matches_jax_interpret_kernel():
    """The port's fused route against JAX's fused Pallas kernel in interpret
    mode (fused_substep="force"): 2 envs, 4 iterations, 2 steps.  Bounds of
    tests/test_fused_substep.py, which include the kernel's polynomial
    atan2/acos.  Marked slow: tracing the interpret-mode kernel takes minutes
    on a CPU."""
    out, _ = _rollouts("force", "force", batch=2, steps=2, iterations=4,
                       seed=1)
    for t in range(2):
        _check_step(*out[t], dict(obs=5e-5, reward=1e-4, pos=5e-6, rot=5e-6,
                                  vel=5e-5, omega=5e-4))


# --------------------------------------------------------------------------
# Distance, ball and fixed joints on a chain
# --------------------------------------------------------------------------

def test_chain_archetype_matches_jax(chains):
    """Builder parity for the new joint kinds (length, init_inv_rot, the
    world-anchored row), as tests/test_torch_builder.py does for the
    ragdoll."""
    jarch, jstate0, tarch, tstate0 = chains
    want, got = archetype_to_numpy(jarch), archetype_to_numpy(tarch)
    assert set(got) == set(want)
    for name in sorted(want):
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-6,
                                   err_msg=name)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tstate0, f)[0].numpy(),
                                   np.asarray(getattr(jstate0, f)), atol=1e-6)


@pytest.fixture(scope="module")
def chain_runs(chains):
    """5 substeps of the unfused plain route from the same disturbed start,
    and the joint preps of the first, on both sides."""
    jarch, jstate0, tarch, tstate0 = chains
    s = _chain_state(jstate0)
    jset = JaxSettings(frame_rate=60, fused_substep="off",
                       solver_backend="xla")
    tset = PhysicsSettings(frame_rate=60, fused_substep="off",
                           solver_backend="plain")

    def jax_prep(state):
        vel, omega, ii_w = jstep.integrate_forces(
            jarch, state.pos, state.rot, state.vel, state.omega, state.force,
            state.torque, DT, jset.global_force_field)
        pos1 = jstep._append_world(state.pos)
        ii_w1 = jnp.concatenate([ii_w, jnp.zeros((1, 3, 3))], 0)
        rot1 = jnp.concatenate([state.rot, jnp.array([[0.0, 0.0, 0.0, 1.0]])])
        ctx = jjoints.JointContext(pos1=pos1, rot1=rot1,
                                   inv_mass1=jarch.inv_mass, ii_w1=ii_w1,
                                   local_cog1=jarch.local_cog, dt=DT)
        return jjoints.prep_all(jarch, ctx, None)

    jsub = jax.jit(jax.vmap(lambda st: jstep.physics_substep(
        jarch, st, DT, jset, None, allow_fused=False)[0]))
    jst = JaxBodyState(**{k: jnp.asarray(v) for k, v in s.items()})
    jpreps = jax.jit(jax.vmap(jax_prep))(jst)
    tst = body_state_from_numpy(s)
    with torch.no_grad():
        tpreps = step.substep_prep(tarch, tst, DT, tset).joint_preps
        jout, tout = [], []
        for _ in range(5):
            jst = jsub(jst)
            tst, _ = step.physics_substep(tarch, tst, DT, tset)
            jout.append(jst)
            tout.append(tst)
    return dict(jax=jout, port=tout, jpreps=jpreps, tpreps=tpreps)


@pytest.mark.parametrize("kind", ["distance", "ball", "fixed"])
def test_chain_joint_prep_matches_jax(chains, chain_runs, kind):
    """Every prep field within 1e-5 of the field's scale, as
    tests/test_torch_physics.py::test_joint_prep_matches_jax."""
    tarch = chains[2]
    k = [t.kind for t in tarch.joints].index(kind)
    got, want = chain_runs["tpreps"][k], chain_runs["jpreps"][k]
    assert set(got) == set(want)
    for name in sorted(got):
        g, w = got[name], np.asarray(want[name])
        if name in ("ia", "ib"):
            np.testing.assert_array_equal(g.numpy(), w[0])
            continue
        w = w.astype(np.float32)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * max(1.0, float(np.abs(w).max())),
                                   err_msg=f"{kind}.{name}")


@pytest.mark.parametrize("field", ["pos", "rot", "vel", "omega"])
def test_chain_steps_match_jax(chain_runs, field):
    """5 substeps of the distance/ball/fixed/hinge chain, unfused plain
    route; after each step within the bounds of one substep
    (tests/test_torch_physics.py)."""
    for t, (j, p) in enumerate(zip(chain_runs["jax"], chain_runs["port"])):
        np.testing.assert_allclose(getattr(p, field).numpy(),
                                   np.asarray(getattr(j, field)),
                                   atol=SUBSTEP_ATOL[field], rtol=0,
                                   err_msg=f"step {t}")


def test_chain_touches_the_ground(chain_runs):
    """The comparison covers contacts: the spheres and boxes rest on the
    plane, and the chain hangs from its anchor."""
    pos = chain_runs["port"][-1].pos
    assert torch.all(pos[:, 1:, 1] < 0.55) and torch.all(pos[:, 1:, 1] > 0.1)
    assert torch.equal(pos[:, 0], chain_runs["port"][0].pos[:, 0])


# --------------------------------------------------------------------------
# The kernel source, compiled as host C++
# --------------------------------------------------------------------------

_STUB_RUNTIME = """\
#pragma once
#include <math.h>
#include <stddef.h>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
static dim3 blockIdx(0), blockDim(1), threadIdx(0);
template <class T> inline T __ldg(const T* p) { return *p; }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0 };
inline cudaError_t cudaSetDevice(int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaLaunchKernel(const void*, dim3, dim3, void**, size_t,
                                    cudaStream_t) { return 0; }
"""

_HARNESS = """\
#include "fused_substep.cu"
// The kernel body once per scene index: one thread per scene, as launched.
extern "C" int host_fused_substep(const FusedArgs* args) {
  blockDim = dim3(1);
  for (int s = 0; s < args->batch; ++s) {
    blockIdx = dim3(s);
    threadIdx = dim3(0);
    fused_substep_kernel(*args);
  }
  return 0;
}
extern "C" int host_args_size() { return (int)sizeof(FusedArgs); }
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/fused_substep.cu built as host C++ (g++, -ffp-contract=off),
    the CUDA qualifiers and runtime stubbed."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source as host code")
    d = tmp_path_factory.mktemp("host_kernel")
    (d / "cuda_runtime.h").write_text(_STUB_RUNTIME)
    (d / "harness.cpp").write_text(_HARNESS)
    lib = d / "libhost_fused.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
                    "-fPIC", f"-I{d}", f"-I{solver_cuda.CSRC_DIR}",
                    str(d / "harness.cpp"), "-o", str(lib)],
                   check=True, capture_output=True, text=True)
    host = ctypes.CDLL(str(lib))
    host.host_fused_substep.argtypes = [ctypes.c_void_p]
    host.host_fused_substep.restype = ctypes.c_int
    host.host_args_size.restype = ctypes.c_int
    assert host.host_args_size() == ctypes.sizeof(substep_cuda.FusedArgs)
    return host


def _run_host(host, state, ovr, consts, post=None):
    args, keep, extras = substep_cuda.launch_args(state, ovr, consts, post)
    assert host.host_fused_substep(ctypes.addressof(args)) == 0
    out = {f: keep[f"{f}_out"] for f in FIELDS}
    return out, extras


def _close_state(got, want, what):
    for f in FIELDS:
        np.testing.assert_allclose(got[f].numpy(), getattr(want, f).numpy(),
                                   rtol=0, atol=SUBSTEP_ATOL[f],
                                   err_msg=f"{what} {f}")


@pytest.fixture(scope="module")
def disturbed_loco():
    """4 ragdolls lowered onto the ground with random velocities, actions
    and one poke each, the last one sunk 1.5 m so that it falls and resets;
    4 solver iterations."""
    env = LocoEnv(settings=PhysicsSettings(frame_rate=60, solver_iterations=4,
                                           fused_substep="off"))
    gen = torch.Generator().manual_seed(0)
    _, st = env.reset(4, gen)
    b = st.bodies
    pos = b.pos - torch.tensor([0.0, 0.125, 0.0])
    pos[3, :, 1] -= 1.5
    b = b.replace(pos=pos.contiguous(),
                  vel=torch.rand(b.vel.shape, generator=gen) - 0.5,
                  omega=torch.rand(b.omega.shape, generator=gen) - 0.5)
    b = env.apply_poke(b, torch.tensor([True, False, True, True]),
                       torch.tensor([1, 2, 3, 4]),
                       torch.tensor([0.3, 1.0, 2.0, 3.0]))
    act = torch.rand((4, ACTION_SIZE), generator=gen) - 0.5
    act[:, 1:21:3] = torch.where(torch.rand((4, 7), generator=gen) < 0.5,
                                 -1.0, 1.0)
    return env, b, act


def test_host_kernel_env_step_matches_plain(host_kernel, disturbed_loco):
    """The whole env step (physics + post stage) against `_step_core`: body
    state within the one-substep bounds, obs 5e-5, reward 1e-4, done exact,
    and the fallen env reset to exactly the standing pose and its obs."""
    env, b, act = disturbed_loco
    with torch.no_grad():
        want_b, want_obs, want_rew, want_done = env._step_core(b, act)
    consts = substep_cuda.pack_consts(env.arch, env.settings, DT,
                                      env._action_columns(), ACTION_SIZE,
                                      "cpu")
    got, extras = _run_host(host_kernel, b, act.contiguous(), consts,
                            env.post_consts())
    assert want_done.tolist() == [False, False, False, True]
    np.testing.assert_array_equal(extras[:, STATE_SIZE + 1].numpy() > 0.5,
                                  want_done.numpy())
    _close_state(got, want_b, "env step")
    np.testing.assert_allclose(extras[:, :STATE_SIZE].numpy(),
                               want_obs.numpy(), rtol=0, atol=5e-5)
    np.testing.assert_allclose(extras[:, STATE_SIZE].numpy(),
                               want_rew.numpy(), rtol=0, atol=1e-4)
    for f in ("pos", "rot", "vel", "omega"):
        assert torch.equal(got[f][3], getattr(env._state0, f)[0]), f
    assert torch.equal(extras[3, :STATE_SIZE], env._obs0)
    assert extras[3, STATE_SIZE] == 0.0


def test_host_kernel_chain_substep_matches_plain(host_kernel, chains):
    """The physics substep alone (no post stage) on the distance / ball /
    fixed / hinge chain with a hole, 30 iterations: rows of kinds 3-5."""
    tarch, tstate0 = chains[2], chains[3]
    state = body_state_from_numpy(_chain_state(tstate0))
    settings = PhysicsSettings(frame_rate=60, fused_substep="off",
                               solver_backend="plain")
    with torch.no_grad():
        want, _ = step.physics_substep(tarch, state, DT, settings)
    consts = substep_cuda.pack_consts(tarch, settings, DT, {}, 0, "cpu")
    got, extras = _run_host(host_kernel, state, None, consts)
    assert extras is None
    _close_state(got, want, "chain substep")


def test_host_kernel_generic_overrides_match_plain(host_kernel,
                                                   disturbed_loco):
    """The generic `physics_substep` route: override leaves concatenated in
    leaf order, no post stage."""
    env, b, act = disturbed_loco
    mo = env._motor_overrides(act)
    with torch.no_grad():
        want, _ = step.physics_substep(env.arch, b, DT, env.settings, mo)
    spec = substep_cuda.override_layout(mo)
    columns, start = {}, 0
    for k, key in spec:
        n = env.arch.joints[k].body_a.shape[0]
        columns[(k, key)] = range(start, start + n)
        start += n
    leaves = torch.cat([d[key] for d in mo if d for key in sorted(d)], dim=1)
    consts = substep_cuda.pack_consts(env.arch, env.settings, DT, columns,
                                      start, "cpu")
    got, _ = _run_host(host_kernel, b, leaves.contiguous(), consts)
    _close_state(got, want, "generic route")


def test_joint_solve_fns_cover_the_fused_family():
    assert set(joints._SOLVE_FNS) == set(substep_cuda._SUPPORTED_JOINTS)
