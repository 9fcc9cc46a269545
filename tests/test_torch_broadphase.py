"""The port's runtime broadphase, split-Jacobi and runtime Gauss-Seidel
contact modes against the JAX package on the CPU.

The scene is `models.scenes.add_stack_drop_1k` at 64 bodies (4 x 4 x 4
alternating boxes and spheres), built by both packages' builders, with its
grid squeezed to a pitch of 0.93 (neighbours overlap by up to 0.1 m) and
seeded noise in position, rotation and velocity: B scenes of one pile with
hundreds of touching pairs.  Three broadphase settings: BASELINE config 1's
own (window 160 > C, row cap 16), a tight one (window 8: the window
overflows; row cap 4: the cap cuts; 96 candidate rows: the first-stage
compaction runs; 40 active rows: `compact_active` cuts) and the dense test.

Tolerances: broadphase indices, masks, overflow counts, degrees and colors
exactly equal; manifolds 1e-5; one solver iteration 1e-5 (vel) and 1e-4
(omega); one substep the physics bars of pos/rot 5e-6, vel 5e-5, omega
5e-4.  The JAX side runs the unfused XLA path; its batched calls go through
`jax.vmap`, as its step runs them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings as hsettings
from hypothesis import strategies as st

from d3d12renderer_tpu.physics import broadphase as jbroad
from d3d12renderer_tpu.physics import collide as jcollide
from d3d12renderer_tpu.physics import solver as jsolver
from d3d12renderer_tpu.physics import step as jstep
from d3d12renderer_tpu.physics.builder import SceneBuilder as JaxBuilder
from d3d12renderer_tpu.physics.types import BodyState as JaxBodyState
from d3d12renderer_tpu.physics.types import PhysicsSettings as JaxSettings
from d3d12renderer_tpu_torch.convert import body_state_from_numpy
from d3d12renderer_tpu_torch.models import scenes
from d3d12renderer_tpu_torch.physics import broadphase, collide, solver, step
from d3d12renderer_tpu_torch.physics.builder import SceneBuilder
from d3d12renderer_tpu_torch.physics.types import PhysicsSettings

torch.set_num_threads(1)

B = 3
BODIES = 64
PITCH = 0.93
DT = 1.0 / 120.0
FIELDS = ("pos", "rot", "vel", "omega", "force", "torque")
CONFIGS = {
    "config1": scenes.STACK_DROP_1K_FINALIZE,
    "tight": dict(broadphase="sap", sap_neighbors=8, sap_row_cap=4,
                  sap_max_contacts=96, sap_active_budget=40),
    "dense": dict(broadphase="sap", sap_algorithm="dense", sap_neighbors=8,
                  sap_active_budget=120),
}


def _squeezed_pile(state0):
    """B noisy copies of the pile with its grid squeezed to PITCH."""
    rng = np.random.default_rng(7)
    pos = np.asarray(state0["pos"], np.float64)
    base = pos.min(0)
    pos = base + (pos - base) * (PITCH / 1.15)
    pos[:, 1] += 0.5 - pos[:, 1].min() - 0.02
    s = {f: np.repeat(np.asarray(state0[f])[None], B, 0).astype(np.float32)
         for f in FIELDS}
    s["pos"] = (pos[None] + rng.normal(0, 0.01, (B,) + pos.shape)).astype(
        np.float32)
    q = s["rot"] + rng.normal(0, 0.05, s["rot"].shape)
    s["rot"] = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(
        np.float32)
    s["vel"] = rng.uniform(-0.5, 0.5, s["vel"].shape).astype(np.float32)
    s["omega"] = rng.uniform(-1.0, 1.0, s["omega"].shape).astype(np.float32)
    return s


def _build(config):
    jb, tb = JaxBuilder(), SceneBuilder()
    for b in (jb, tb):
        scenes.add_stack_drop_1k(b, BODIES, seed=0)
    jarch, jstate0 = jb.finalize(**config)
    tarch, _ = tb.finalize(device="cpu", **config)
    s = _squeezed_pile({f: np.asarray(getattr(jstate0, f)) for f in FIELDS})
    return jarch, tarch, s


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pile(request):
    """Both archetypes, the numpy states, and each package's world poses,
    AABBs, candidates, manifolds and compacted table."""
    jarch, tarch, s = _build(CONFIGS[request.param])
    jst = JaxBodyState(**{f: jnp.asarray(v) for f, v in s.items()})
    tst = body_state_from_numpy(s, device="cpu")

    def jax_side(state):
        wpos, wrot = jcollide.collider_world_poses(jarch, state)
        amin, amax = jbroad.world_aabbs(jarch, wpos, wrot)
        if jarch.sap_mode == "sweep":
            cand = jbroad.candidate_pairs_swept(jarch, amin, amax)
        else:
            j_idx, valid, overflow = jbroad.candidate_pairs(jarch, amin, amax)
            cand = (jnp.broadcast_to(jnp.arange(j_idx.shape[0])[:, None],
                                     j_idx.shape), j_idx, valid, overflow)
        table = jbroad.sap_manifolds(jarch, wpos, wrot)
        compact = jbroad.compact_active(table, jarch.sap_active_budget)
        return (amin, amax) + tuple(cand) + (table, compact)

    jout = jax.device_get(jax.jit(jax.vmap(jax_side))(jst))
    wpos, wrot = collide.collider_world_poses(tarch, tst)
    amin, amax = broadphase.world_aabbs(tarch, wpos, wrot)
    cand = broadphase._candidates(tarch, amin, amax)
    table = broadphase.sap_manifolds(tarch, wpos, wrot)
    compact = broadphase.compact_active(table, tarch.sap_active_budget)
    tout = (amin, amax) + tuple(cand) + (table, compact)
    return dict(name=request.param, jarch=jarch, tarch=tarch, state=s,
                jst=jst, tst=tst, jax=jout, port=tout)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, atol, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= atol, f"{what}: max |err| {err:.3e} > {atol}"


def test_world_aabbs_match_jax(pile):
    for k, what in ((0, "amin"), (1, "amax")):
        _close(pile["port"][k], pile["jax"][k], 1e-6, what)


def test_candidates_and_overflow_match_jax(pile):
    """Candidate sets per scene equal, overflow counts equal; the tight
    window and row cap must cut."""
    ji, jj, jv, jo = pile["jax"][2:6]
    ti, tj, tv, to = (_np(x) for x in pile["port"][2:6])
    np.testing.assert_array_equal(to, jo)
    for s in range(B):
        want = {(min(a, b), max(a, b)) for a, b, v in
                zip(ji[s].ravel(), jj[s].ravel(), jv[s].ravel()) if v}
        got = {(min(a, b), max(a, b)) for a, b, v in
               zip(ti[s].ravel(), tj[s].ravel(), tv[s].ravel()) if v}
        assert got == want and len(got) > 100, (s, len(got), len(want))
    if pile["name"] == "tight":
        assert (to > 0).all()
    # Same order, not only the same sets (the rows the compaction keeps).
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tj, jj)
    np.testing.assert_array_equal(tv, jv)


def _table_close(got, want, what):
    for f in ("body_a", "body_b", "active", "pmask"):
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{what}.{f}")
    act = np.asarray(want.active)
    pm = np.asarray(want.pmask)
    _close(_np(got.normal)[act], np.asarray(want.normal)[act], 1e-5,
           f"{what}.normal")
    _close(_np(got.point)[pm], np.asarray(want.point)[pm], 1e-5,
           f"{what}.point")
    _close(_np(got.depth)[pm], np.asarray(want.depth)[pm], 1e-5,
           f"{what}.depth")
    for f in ("friction", "restitution"):
        _close(getattr(got, f).expand(want.active.shape),
               np.asarray(getattr(want, f)), 1e-7, f"{what}.{f}")


def test_sap_manifolds_match_jax(pile):
    table = pile["jax"][6]
    assert np.asarray(table.active).sum() > 20 * B
    _table_close(pile["port"][6], table, "sap_manifolds")


def test_compact_active_matches_jax(pile):
    """The compacted table equals JAX's; every active row of the full table
    is kept where the budget holds them all (each body pair once per scene
    here, so a pair names a row)."""
    full, compact = pile["port"][6], pile["port"][7]
    _table_close(compact, pile["jax"][7], "compact_active")
    budget = pile["tarch"].sap_active_budget
    for s in range(B):
        act = _np(full.active[s])

        def rows(t):
            a = _np(t.active[s])
            return {(int(x), int(y), float(d)) for x, y, d in zip(
                _np(t.body_a[s])[a], _np(t.body_b[s])[a],
                _np(t.depth[s, :, 0])[a])}

        if act.sum() <= budget:
            assert rows(compact) == rows(full)
        else:
            assert _np(compact.active[s]).all()


def _solver_inputs(pile):
    """Both packages' contact tables (plane rows + compacted broadphase
    rows), degrees and split-Jacobi preps of one substep."""
    jarch, tarch = pile["jarch"], pile["tarch"]
    n = tarch.num_bodies

    def jax_side(state):
        ct = jcollide.generate_contacts(jarch, state)
        ct = jbroad.compact_active(ct, jarch.sap_active_budget)
        vel, omega, ii_w = jstep.integrate_forces(
            jarch, state.pos, state.rot, state.vel, state.omega, state.force,
            state.torque, DT, (0.0, 0.0, 0.0))
        pos1 = jstep._append_world(state.pos)
        vel1, omega1 = jstep._append_world(vel), jstep._append_world(omega)
        ii_w1 = jnp.concatenate([ii_w, jnp.zeros((1, 3, 3))], 0)
        deg = jsolver.contact_degrees(ct, n + 1)
        prep = jsolver.prep_contacts_full(
            ct, pos1, jarch.inv_mass, ii_w1, vel1, omega1, DT,
            inv_mass_eff=jarch.inv_mass * deg,
            inv_inertia_eff=ii_w1 * deg[:, None, None])
        gs_prep = jsolver.prep_contacts_full(ct, pos1, jarch.inv_mass, ii_w1,
                                             vel1, omega1, DT)
        color, left = jsolver.runtime_color(
            ct.body_a, ct.body_b, ct.active, jarch.inv_mass[ct.body_a] > 0,
            jarch.inv_mass[ct.body_b] > 0, n + 1, 32)
        imp = jnp.zeros(ct.pmask.shape)
        sa = jsolver.body_onehot(ct.body_a, n + 1)
        sb = jsolver.body_onehot(ct.body_b, n + 1)
        scatter = jsolver.solve_contacts_split_jacobi(prep, vel1, omega1, imp,
                                                      imp)
        matmul = jsolver.solve_contacts_split_jacobi_matmul(
            prep, vel1, omega1, imp, imp, sa, sb)
        gs = jsolver.solve_contacts_runtime_gs(gs_prep, color, 32, vel1,
                                               omega1, imp, imp)
        return ct, deg, color, left, scatter, matmul, gs

    jout = jax.device_get(jax.jit(jax.vmap(jax_side))(pile["jst"]))
    return jout


@pytest.fixture(scope="module")
def solved(pile):
    """The port's pieces of one substep (`step.substep_prep`) beside JAX's."""
    tarch = pile["tarch"]
    sp = {}
    for mode in ("split_jacobi", "runtime_gs"):
        sp[mode] = step.substep_prep(
            tarch, pile["tst"], DT,
            PhysicsSettings(frame_rate=120, contact_mode=mode))
    return dict(jax=_solver_inputs(pile), port=sp)


def test_contact_table_and_degrees_match_jax(pile, solved):
    jct, jdeg = solved["jax"][:2]
    sp = solved["port"]["split_jacobi"]
    _table_close(sp.contacts, jct, "generate_contacts + compact_active")
    deg = solver.contact_degrees(sp.contacts, pile["tarch"].num_bodies + 1)
    np.testing.assert_array_equal(_np(deg), np.asarray(jdeg))
    assert np.asarray(jdeg).max() >= 4


@pytest.mark.parametrize("branch", ["scatter", "matmul"])
def test_split_jacobi_iteration_matches_jax(pile, solved, branch):
    """One Jacobi iteration of the port against JAX's scatter-add branch and
    its one-hot matmul branch (the threshold forced each way), from the
    port's own prep."""
    want = solved["jax"][4 if branch == "scatter" else 5]
    sp = solved["port"]["split_jacobi"]
    vel, omega = sp.vel1.clone(), sp.omega1.clone()
    imp_n = torch.zeros(sp.contact_prep.pmask.shape)
    imp_t = torch.zeros(sp.contact_prep.pmask.shape)
    solver.solve_contacts_split_jacobi(sp.contact_prep, vel, omega, imp_n,
                                       imp_t)
    for got, w, tol, what in ((vel, want[0], 1e-5, "vel"),
                              (omega, want[1], 1e-4, "omega"),
                              (imp_n, want[2], 1e-4, "imp_n"),
                              (imp_t, want[3], 1e-4, "imp_t")):
        _close(got, w, tol, f"{branch} {what}")
    assert float(imp_n.abs().max()) > 0.01


def test_runtime_color_matches_jax(pile, solved):
    """The claimed colors are integers from an order-free rule: equal."""
    jcolor, jleft = solved["jax"][2:4]
    sp = solved["port"]["runtime_gs"]
    np.testing.assert_array_equal(_np(sp.contact_colors), np.asarray(jcolor))
    # The leftover rows (never claimed) sit in the last color.
    left = np.sum(_np(sp.contacts.active) & (_np(sp.contact_colors) == 31), -1)
    np.testing.assert_array_equal(left, np.asarray(jleft))
    assert len(set(np.asarray(jcolor)[np.asarray(
        solved["jax"][0].active)].tolist())) >= 3


def test_runtime_gs_iteration_matches_jax(pile, solved):
    """One runtime Gauss-Seidel iteration over the 32 colors."""
    want = solved["jax"][6]
    sp = solved["port"]["runtime_gs"]
    vel, omega = sp.vel1.clone(), sp.omega1.clone()
    imp_n = torch.zeros(sp.contact_prep.pmask.shape)
    imp_t = torch.zeros(sp.contact_prep.pmask.shape)
    solver.solve_contacts_runtime_gs(sp.contact_prep, sp.contact_colors, 32,
                                     vel, omega, imp_n, imp_t)
    _close(vel, want[0], 1e-5, "vel")
    _close(omega, want[1], 1e-4, "omega")
    _close(imp_n, want[2], 1e-4, "imp_n")
    _close(imp_t, want[3], 1e-4, "imp_t")


@st.composite
def _contact_graphs(draw):
    p = draw(st.integers(1, 120))
    nb = draw(st.integers(2, 30))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    ia = rng.integers(0, nb, (2, p))
    ib = rng.integers(0, nb - 1, (2, p))
    ib = np.where(ib >= ia, ib + 1, ib)
    active = rng.random((2, p)) < draw(st.floats(0.2, 1.0))
    dyn = rng.random(nb + 1) < 0.8
    dyn[nb] = False
    return ia, ib, active, dyn, nb


@hsettings(max_examples=12, deadline=None,
           suppress_health_check=[HealthCheck.too_slow])
@given(_contact_graphs())
def test_runtime_color_conflict_free_and_equal(graph):
    """Random graphs with static bodies: the port's colors equal JAX's,
    and rows of one claimed color share no dynamic body."""
    ia, ib, active, dyn, nb = graph
    t = lambda x: torch.as_tensor(x)  # noqa: E731
    color, left = solver.runtime_color(t(ia), t(ib), t(active), t(dyn[ia]),
                                       t(dyn[ib]), nb + 1, 8)
    jfn = jax.vmap(lambda a, b, act, da, db: jsolver.runtime_color(
        a, b, act, da, db, nb + 1, 8))
    jcolor, jleft = jfn(jnp.asarray(ia, jnp.int32), jnp.asarray(ib, jnp.int32),
                        jnp.asarray(active), jnp.asarray(dyn[ia]),
                        jnp.asarray(dyn[ib]))
    np.testing.assert_array_equal(color.numpy(), np.asarray(jcolor))
    np.testing.assert_array_equal(left.numpy(), np.asarray(jleft))
    for s in range(2):
        for c in range(7):
            rows = np.nonzero((color[s].numpy() == c) & active[s])[0]
            used = [x for x in np.concatenate([ia[s, rows], ib[s, rows]])
                    if dyn[x]]
            assert len(used) == len(set(used)), (s, c)


@pytest.fixture(scope="module")
def substeps():
    """One whole substep of the config-1 pile in both modes, both
    packages."""
    jarch, tarch, s = _build(CONFIGS["config1"])
    jst = JaxBodyState(**{f: jnp.asarray(v) for f, v in s.items()})
    tst = body_state_from_numpy(s, device="cpu")
    out = {}
    for mode in ("split_jacobi", "runtime_gs"):
        js = JaxSettings(frame_rate=120, contact_mode=mode)
        jfn = jax.jit(jax.vmap(lambda st: jstep.physics_substep(
            jarch, st, DT, js)[0]))
        want = jax.device_get(jfn(jst))
        got, _ = step.physics_substep(
            tarch, tst, DT, PhysicsSettings(frame_rate=120, contact_mode=mode))
        out[mode] = (got, want)
    return out


@pytest.mark.parametrize("mode", ["split_jacobi", "runtime_gs"])
@pytest.mark.parametrize("field,atol", [
    ("pos", 5e-6), ("rot", 5e-6), ("vel", 5e-5), ("omega", 5e-4),
])
def test_sap_substep_matches_jax(substeps, mode, field, atol):
    got, want = substeps[mode]
    _close(getattr(got, field), getattr(want, field), atol, f"{mode} {field}")


def test_colored_mode_refuses_sap():
    """JAX's ValueError for a runtime-broadphase scene in colored mode, on
    every fused setting."""
    b = SceneBuilder()
    scenes.add_stack_drop_1k(b, 8)
    arch, state = b.finalize(device="cpu", **CONFIGS["tight"])
    for fused in ("auto", "force", "off"):
        with pytest.raises(ValueError, match="split_jacobi"):
            step.physics_step(arch, state, PhysicsSettings(
                frame_rate=120, fused_substep=fused), 1.0 / 60.0)


def test_world_aabbs_of_every_shape_match_jax():
    """Spheres and boxes exact, capsules, cylinders and hulls by their bound
    radius, at seeded poses."""
    rng = np.random.default_rng(3)
    hull_pts = rng.normal(0, 0.4, (40, 3))
    jb, tb = JaxBuilder(), SceneBuilder()
    for b in (jb, tb):
        b.add_static_plane((0.0, 1.0, 0.0), 0.0)
        for i in range(5):
            body = b.add_body((float(i), 1.0, 0.0))
            [lambda: b.add_sphere_collider(body, 0.3),
             lambda: b.add_capsule_collider(body, 0.2, 0.4),
             lambda: b.add_box_collider(body, (0.3, 0.2, 0.5)),
             lambda: b.add_cylinder_collider(body, 0.4, 0.1),
             lambda: b.add_hull_collider(body, hull_pts)][i]()
        b.finalize_kwargs = dict(broadphase="sap", sap_neighbors=4)
    jarch, _ = jb.finalize(**jb.finalize_kwargs)
    tarch, _ = tb.finalize(device="cpu", **tb.finalize_kwargs)
    q = rng.normal(0, 1, (B, 5, 4))
    s = {"pos": rng.uniform(-2, 2, (B, 5, 3)),
         "rot": q / np.linalg.norm(q, axis=-1, keepdims=True)}
    s = {k: v.astype(np.float32) for k, v in s.items()}
    for f in ("vel", "omega", "force", "torque"):
        s[f] = np.zeros((B, 5, 3), np.float32)
    jst = JaxBodyState(**{f: jnp.asarray(v) for f, v in s.items()})
    want = jax.vmap(lambda st: jbroad.world_aabbs(
        jarch, *jcollide.collider_world_poses(jarch, st)))(jst)
    tst = body_state_from_numpy(s, device="cpu")
    got = broadphase.world_aabbs(
        tarch, *collide.collider_world_poses(tarch, tst))
    for g, w, what in zip(got, want, ("amin", "amax")):
        _close(g, w, 1e-6, what)
