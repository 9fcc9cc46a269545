"""The port's scene builder, ragdoll and maths against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3d12renderer_tpu.core import maths as jmaths
from d3d12renderer_tpu.learning.loco_env import LocoEnv as JaxLocoEnv
from d3d12renderer_tpu.physics.builder import SceneBuilder as JaxSceneBuilder
from d3d12renderer_tpu.physics.types import PhysicsSettings as JaxSettings
from d3d12renderer_tpu_torch.convert import archetype_to_numpy
from d3d12renderer_tpu_torch.core import maths
from d3d12renderer_tpu_torch.learning.loco_env import LocoEnv
from d3d12renderer_tpu_torch.models import scenes
from d3d12renderer_tpu_torch.physics.builder import SceneBuilder
from d3d12renderer_tpu_torch.physics.types import MAX_HULL_VERTS

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def envs():
    return (JaxLocoEnv(settings=JaxSettings(frame_rate=60, fused_substep="off",
                                            solver_backend="xla")),
            LocoEnv(device="cpu"))


def test_ragdoll_archetype_matches_jax(envs):
    """Every archetype array the port has: integers and colors exact,
    floats within 1e-6."""
    jenv, tenv = envs
    want = archetype_to_numpy(jenv.arch)
    got = archetype_to_numpy(tenv.arch)
    assert set(got) == set(want)
    for name in sorted(want):
        g, w = got[name], want[name]
        assert g.shape == w.shape and g.dtype.kind == w.dtype.kind, name
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    # The archetype the port's solver kernel is written for.
    kinds = [t.kind for t in tenv.arch.joints]
    assert kinds == ["cone_twist", "hinge"]
    assert [len(c) for c in tenv.arch.joint_color_indices] == [5, 1]
    assert [len(c) for c in tenv.arch.contact_color_indices] == [14, 1, 1, 1]
    assert tenv.arch.num_bodies == 14 and got["vs_plane_body"].shape == (17,)


@pytest.mark.parametrize("field", ["pos", "rot", "vel", "omega", "force",
                                   "torque"])
def test_initial_state_matches_jax(envs, field):
    jenv, tenv = envs
    np.testing.assert_allclose(getattr(tenv._state0, field)[0].numpy(),
                               np.asarray(getattr(jenv._state0, field)),
                               rtol=0, atol=1e-6)


def _two_spheres(b):
    b.add_static_plane((0.0, 1.0, 0.0), 0.0)
    a = b.add_body((0.0, 1.0, 0.0))
    c = b.add_body((0.0, 2.0, 0.0))
    b.add_sphere_collider(a, radius=0.5)
    b.add_sphere_collider(c, radius=0.5)
    return a, c


def _assert_same_archetype(got, want):
    """Field by field: ints and masks equal, floats within 1e-6."""
    got, want = archetype_to_numpy(got), archetype_to_numpy(want)
    assert set(got) == set(want)
    for name in sorted(want):
        g, w = got[name], want[name]
        assert g.shape == w.shape and g.dtype.kind == w.dtype.kind, name
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


_TETRAHEDRON = np.vstack([np.zeros(3), np.eye(3)]) - 0.25


# (call on the two-sphere scene, finalize arguments): what earlier slices
# refused now compiles: the runtime broadphase, force fields, triggers,
# terrains, hull and cylinder colliders.
@pytest.mark.parametrize("call,finalize", [
    (lambda b: None, dict(broadphase="sap")),
    (lambda b: b.add_force_field((0, 1, 0), 1.0, 10.0), {}),
    (lambda b: b.add_trigger((0, 1, 0), 1.0), {}),
    (lambda b: b.add_terrain(np.zeros((4, 4))), {}),
    (lambda b: b.add_hull_collider(0, _TETRAHEDRON), {}),
    (lambda b: b.add_cylinder_collider(0, 0.5, 0.5), {}),
], ids=[f"unported{i}" for i in range(6)])
def test_builder_refuses_what_is_not_ported(call, finalize):
    """Every scene the port's builder once refused compiles to JAX's
    archetype: the runtime broadphase, hulls and cylinders, force
    fields, triggers and terrains (their rows, colors and tables)."""
    jb, tb = JaxSceneBuilder(), SceneBuilder()
    for b in (jb, tb):
        _two_spheres(b)
        call(b)
    _assert_same_archetype(tb.finalize(device="cpu", **finalize)[0],
                           jb.finalize(**finalize)[0])


def _world(b):
    """Planes, two terrains of one resolution, bodies of every plane-row
    shape and a kinematic one (no rows), colliding pairs, force fields and
    triggers: plane rows, terrain rows and buckets in one coloring."""
    rng = np.random.default_rng(3)
    b.add_static_plane((0.0, 1.0, 0.0), -2.0)
    b.add_static_plane((1.0, 0.2, 0.0), -5.0, friction=0.5)
    b.add_terrain(rng.normal(0, 0.3, (9, 7)), origin=(-4.0, 0.0, -3.0),
                  cell_size=1.0, friction=0.6, restitution=0.1)
    b.add_terrain(rng.normal(0, 0.3, (9, 7)), origin=(4.0, 0.5, -3.0),
                  cell_size=0.5)
    bodies = [b.add_body((0.5 * i, 1.0, 0.3 * i)) for i in range(4)]
    b.add_sphere_collider(bodies[0], 0.4)
    b.add_box_collider(bodies[1], (0.3, 0.2, 0.3))
    b.add_capsule_collider(bodies[2], 0.2, 0.3)
    b.add_sphere_collider(bodies[2], 0.2, center=(0.0, 0.5, 0.0))
    b.add_hull_collider(bodies[3], _TETRAHEDRON)
    b.add_box_collider(b.add_body((3.0, 3.0, 0.0), kinematic=True),
                       (0.5, 0.5, 0.5))
    b.add_force_field((0.0, 1.0, 0.0), 2.0, (0.0, 20.0, 0.0))
    b.add_force_field((1.0, 0.0, 1.0), 0.5, (1.0, 2.0, 3.0))
    b.add_trigger((1.0, 1.0, 1.0), 1.5)


@pytest.mark.parametrize("terrain_collision", ["bilinear", "triangles"])
def test_terrain_fields_and_triggers_match_jax(terrain_collision):
    """terrain_* / vs_terrain_* / ff_* / trigger_* arrays, the terrain
    segments, terrain_tri_exact and contact_color_indices (terrain rows
    colored between the plane rows and the buckets) equal JAX's."""
    jb, tb = JaxSceneBuilder(), SceneBuilder()
    _world(jb)
    _world(tb)
    fin = dict(terrain_collision=terrain_collision)
    jarch, _ = jb.finalize(**fin)
    tarch, _ = tb.finalize(device="cpu", **fin)
    _assert_same_archetype(tarch, jarch)
    got = archetype_to_numpy(tarch)
    assert got["terrain_height"].shape == (2, 9, 7)
    assert tarch.num_terrains == 2 and tarch.vs_terrain_collider.shape == (10,)
    assert tarch.vs_terrain_segments == jarch.vs_terrain_segments
    assert tarch.terrain_tri_exact == (terrain_collision == "triangles")
    assert got["ff_force"].shape == (2, 3) and got["trigger_radius"].shape == (1,)
    # Plane, terrain and pair rows all take colors.
    rows = np.concatenate([i.numpy() for i in tarch.contact_color_indices])
    assert sorted(rows.tolist()) == list(range(tarch.num_contact_rows))
    assert tarch.contact_buckets
def _convex_zoo(b, rng):
    """Bodies with hulls (one of 60 points on an ellipsoid, capped at
    MAX_HULL_VERTS), cylinders and boxes at offsets and rotations, one
    hinge."""
    b.add_static_plane((0.0, 1.0, 0.0), 0.0)
    turn = (0.0, 0.0, np.sin(0.3), np.cos(0.3))
    for i in range(4):
        body = b.add_body((1.5 * i, 1.0, 0.0), mass=(2.0 if i == 3 else None))
        pts = rng.normal(0, 1, (60 if i == 0 else 12, 3))
        if i == 0:
            pts = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
        b.add_hull_collider(body, pts * [0.3, 0.2, 0.25],
                            center=(0.1, 0.0, 0.05 * i), rotation=turn,
                            density=500.0 + 100 * i)
        b.add_cylinder_collider(body, 0.2 + 0.05 * i, 0.3, center=(0, 0.4, 0),
                                rotation=turn)
        if i % 2:
            b.add_box_collider(body, (0.1, 0.2, 0.3), center=(0, -0.3, 0))
    b.add_hinge_joint(0, 1, (0.75, 1.0, 0.0), (0.0, 0.0, 1.0))


@pytest.mark.parametrize("finalize", [
    {}, dict(broadphase="sap"),
    dict(broadphase="sap", sap_neighbors=8, sap_max_contacts=40,
         sap_algorithm="dense", sap_active_budget=20, sap_row_cap=4),
], ids=["static", "sap", "sap_dense"])
def test_hull_and_cylinder_tables_match_jax(finalize):
    """Hull mass properties (tetrahedra of the scipy hull) and the padded
    vertex tables, cylinder masses, bound radii, pair buckets or the
    broadphase's tables: JAX's archetype and initial state."""
    jb, tb = JaxSceneBuilder(), SceneBuilder()
    for b in (jb, tb):
        _convex_zoo(b, np.random.default_rng(5))
    jarch, jstate = jb.finalize(**finalize)
    tarch, tstate = tb.finalize(device="cpu", **finalize)
    _assert_same_archetype(tarch, jarch)
    assert int(tarch.col_hull_mask[0].sum()) == MAX_HULL_VERTS
    assert bool(tarch.col_hull_mask[1:].any())
    for f in ("pos", "rot"):
        np.testing.assert_allclose(getattr(tstate, f)[0].numpy(),
                                   np.asarray(getattr(jstate, f)), rtol=0,
                                   atol=1e-6)


def test_stack_drop_1k_archetype_matches_jax():
    """BASELINE config 1's scene at 1,000 bodies through both builders with
    its broadphase settings: every table, the (C, C) admissibility and the
    per-body attributes of the sweep included."""
    jb, tb = JaxSceneBuilder(), SceneBuilder()
    for b in (jb, tb):
        scenes.add_stack_drop_1k(b, 1000)
    jarch, jstate = jb.finalize(**scenes.STACK_DROP_1K_FINALIZE)
    tarch, tstate = tb.finalize(device="cpu", **scenes.STACK_DROP_1K_FINALIZE)
    _assert_same_archetype(tarch, jarch)
    assert (tarch.sap_neighbors, tarch.sap_max_contacts, tarch.sap_row_cap,
            tarch.sap_active_budget, tarch.sap_mode) == (160, 4096, 16, 3072,
                                                         "sweep")
    assert tarch.sap_type_pairs == ((0, 0), (0, 2), (2, 2))
    assert tarch.contact_buckets == () and tarch.num_colliders == 1000
    assert int(tarch.sap_collidable.sum()) == 1000 * 999 // 2
    np.testing.assert_allclose(tstate.pos[0].numpy(), np.asarray(jstate.pos),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("now_ported", [
    lambda b: None,                                             # collider pair
    lambda b: b.add_slider_joint(0, 1, (0, 1.5, 0), (0, 1, 0)),
    lambda b: (b.add_ball_joint(0, 1, (0, 1.5, 0)),             # jointed bodies
               b.add_body((0, 3, 0)), b.add_sphere_collider(2, 0.5)),  # + third
    lambda b: b.add_joint("slider", 0, 1),
])
def test_builder_compiles_pairs_and_sliders(now_ported):
    """Scenes the builder refused before collider pairs and sliders were
    ported: each compiles to JAX's archetype (pair buckets, colors, joint
    tables)."""
    jb, tb = JaxSceneBuilder(), SceneBuilder()
    for b in (jb, tb):
        _two_spheres(b)
        now_ported(b)
    _assert_same_archetype(tb.finalize(device="cpu")[0], jb.finalize()[0])


def test_unknown_joint_kind_is_refused():
    b = SceneBuilder()
    _two_spheres(b)
    with pytest.raises(ValueError, match="joint kind"):
        b.add_joint("gear", 0, 1)


@pytest.mark.parametrize("add,kind,params", [
    (lambda b: b.add_ball_joint(0, 1, (0, 1.5, 0)), "ball",
     {"anchor_a": [0, 0.5, 0], "anchor_b": [0, -0.5, 0]}),
    (lambda b: b.add_distance_joint(0, 1, (0, 1, 0), (0, 2.5, 0)), "distance",
     {"anchor_a": [0, 0, 0], "anchor_b": [0, 0.5, 0], "length": 1.5}),
    (lambda b: b.add_fixed_joint(0, 1, (0, 1.5, 0)), "fixed",
     {"anchor_a": [0, 0.5, 0], "init_inv_rot": [0, 0, 0, 1]}),
])
def test_distance_ball_fixed_joints_compile(add, kind, params):
    """A joint between the two spheres also keeps them from colliding."""
    b = SceneBuilder()
    _two_spheres(b)
    add(b)
    arch, _ = b.finalize(device="cpu")
    (table,) = arch.joints
    assert table.kind == kind
    assert (table.body_a.tolist(), table.body_b.tolist()) == ([0], [1])
    for name, want in params.items():
        np.testing.assert_allclose(table.params[name][0].numpy(), want,
                                   atol=1e-6, err_msg=name)


def test_grouped_spheres_compile_to_plane_rows():
    b = SceneBuilder()
    a, c = _two_spheres(b)
    g = b.new_no_collide_group()
    b.set_no_collide_group(a, g)
    b.set_no_collide_group(c, g)
    arch, state = b.finalize(device="cpu")
    assert arch.vs_plane_body.tolist() == [0, 1]
    assert [i.tolist() for i in arch.contact_color_indices] == [[0, 1]]
    assert state.pos.shape == (1, 2, 3)


def _rand(rng, *shape):
    return rng.normal(0, 1, shape).astype(np.float32)


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("name,make", [
    ("cross", lambda r: (_rand(r, 9, 3), _rand(r, 9, 3))),
    ("quat_mul", lambda r: (_unit(_rand(r, 9, 4)), _unit(_rand(r, 9, 4)))),
    ("quat_conj", lambda r: (_unit(_rand(r, 9, 4)),)),
    ("quat_rotate", lambda r: (_unit(_rand(r, 9, 4)), _rand(r, 9, 3))),
    ("quat_inv_rotate", lambda r: (_unit(_rand(r, 9, 4)), _rand(r, 9, 3))),
    ("quat_to_mat3", lambda r: (_unit(_rand(r, 9, 4)),)),
    ("quat_integrate", lambda r: (_unit(_rand(r, 9, 4)), _rand(r, 9, 3), 1 / 60)),
    ("quat_twist_angle", lambda r: (_unit(_rand(r, 9, 4)), _unit(_rand(r, 9, 3)))),
    ("quat_to_axis_angle", lambda r: (_unit(_rand(r, 9, 4)),)),
    ("quat_from_to", lambda r: (_unit(_rand(r, 9, 3)), _unit(_rand(r, 9, 3)))),
    ("quat_from_axis_angle", lambda r: (_unit(_rand(r, 9, 3)), _rand(r, 9))),
    ("orthonormal_basis", lambda r: (_unit(_rand(r, 9, 3)),)),
    ("normalize", lambda r: (_rand(r, 9, 3),)),
    ("noz", lambda r: (np.concatenate([_rand(r, 8, 3), np.zeros((1, 3), np.float32)]),)),
    ("length", lambda r: (_rand(r, 9, 3),)),
    ("dot", lambda r: (_rand(r, 9, 3), _rand(r, 9, 3))),
])
def test_maths_matches_jax(name, make):
    args = make(np.random.default_rng(0))
    want = getattr(jmaths, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray)
                                   else a for a in args))
    got = getattr(maths, name)(*(torch.as_tensor(a) if isinstance(a, np.ndarray)
                                 else a for a in args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=2e-6)


@pytest.mark.parametrize("scene", ["world", "ragdoll", "stack_1k"])
def test_archetype_round_trip_through_numpy(envs, scene):
    """`archetype_from_numpy` inverts `archetype_to_numpy` on the port's
    archetypes, and a JAX-built archetype converts into the port's: the
    terrain, force-field and trigger fields, buckets, joint tables and
    colors included; the converted terrain scene collides as the built
    one."""
    from d3d12renderer_tpu_torch.convert import archetype_from_numpy
    from d3d12renderer_tpu_torch.physics import collide

    jb, tb = JaxSceneBuilder(), SceneBuilder()
    if scene == "world":
        _world(jb)
        _world(tb)
        fin = dict(terrain_collision="triangles")
    elif scene == "stack_1k":
        for b in (jb, tb):
            scenes.add_stack_drop_1k(b, 64)
        fin = scenes.STACK_DROP_1K_FINALIZE
    if scene == "ragdoll":
        jarch, tarch = envs[0].arch, envs[1].arch
    else:
        jarch = jb.finalize(**fin)[0]
        tarch, tstate = tb.finalize(device="cpu", **fin)
    flat = archetype_to_numpy(tarch)
    back = archetype_from_numpy(flat, device="cpu")
    _assert_same_archetype(back, tarch)
    assert (back.vs_terrain_segments, back.terrain_tri_exact, back.sap_mode,
            back.sap_type_pairs) == (tarch.vs_terrain_segments,
                                     tarch.terrain_tri_exact, tarch.sap_mode,
                                     tarch.sap_type_pairs)
    from_jax = archetype_from_numpy(archetype_to_numpy(jarch), device="cpu")
    _assert_same_archetype(from_jax, tarch)
    if scene == "world":
        want = collide.generate_contacts(tarch, tstate)
        got = collide.generate_contacts(from_jax, tstate)
        for f in ("normal", "point", "depth", "pmask", "active"):
            torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                       rtol=0, atol=1e-6)
