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
from d3d12renderer_tpu_torch.physics.builder import SceneBuilder

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


@pytest.mark.parametrize("unported", [
    lambda b: b.finalize(broadphase="sap", device="cpu"),
    lambda b: b.add_force_field((0, 1, 0), 1.0, 10.0),
    lambda b: b.add_trigger((0, 1, 0), 1.0),
    lambda b: b.add_terrain(np.zeros((4, 4))),
    lambda b: b.add_hull_collider(0, np.eye(3)),
    lambda b: b.add_cylinder_collider(0, 0.5, 0.5),
])
def test_builder_refuses_what_is_not_ported(unported):
    b = SceneBuilder()
    _two_spheres(b)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        unported(b)


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
    want = archetype_to_numpy(jb.finalize()[0])
    got = archetype_to_numpy(tb.finalize(device="cpu")[0])
    assert set(got) == set(want)
    for name in sorted(want):
        g, w = got[name], want[name]
        assert g.shape == w.shape and g.dtype.kind == w.dtype.kind, name
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=name)


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
