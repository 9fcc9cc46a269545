"""The port's entity scene (`scene/components.py`, `scene/scene.py`)
against the JAX package's on the CPU, for two scenes built by both
packages from one document: tests/test_scene.py's demo (a ball over a
plane, a ground quad, the sun) and tools/scene_viewer.py's demo (spheres,
a box, a torus, a ground quad, a kinematic post with a motorized hinged
paddle, the sun; `scene.viewer.build_demo_scene`).

View semantics and clone independence; YAML written by either package
read by the other into equal components, the two texts equal;
`compile_physics`' archetype, state and mapping equal (integers exact,
floats ARCH_TOL) and one `physics_step` of each scene, touching and
moving, within the physics tests' bars (pos/rot 5e-6, vel 5e-5, omega
5e-4);
`compile_cloths` equal; `build_render_scene`'s BVH, materials and sky
equal to JAX's (integers exact, floats ARCH_TOL), at the authored poses
and at body poses."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3d12renderer_tpu.physics import step as jstep
from d3d12renderer_tpu.physics.types import BodyState as JBodyState
from d3d12renderer_tpu.physics.types import PhysicsSettings as JSettings
from d3d12renderer_tpu.scene import components as JC
from d3d12renderer_tpu.scene.scene import Scene as JScene
from d3d12renderer_tpu_torch.convert import (archetype_to_numpy,
                                             body_state_from_numpy)
from d3d12renderer_tpu_torch.physics import step as tstep
from d3d12renderer_tpu_torch.physics.types import PhysicsSettings
from d3d12renderer_tpu_torch.scene import components as TC
from d3d12renderer_tpu_torch.scene import viewer
from d3d12renderer_tpu_torch.scene.scene import Scene as TScene

torch.set_num_threads(1)

ARCH_TOL = 1e-6
BARS = {"pos": 5e-6, "rot": 5e-6, "vel": 5e-5, "omega": 5e-4}
BODY_FIELDS = ("pos", "rot", "vel", "omega", "force", "torque")


def _test_scene_doc():
    """tests/test_scene.py's build_demo_scene, as a document."""
    s = TScene()
    s.add_static_plane((0, 1, 0), 0.0)
    ball = s.create_entity("Ball")
    ball.add_component(TC.Transform(position=(0.0, 3.0, 0.0)))
    ball.add_component(TC.RigidBody())
    ball.add_component(TC.Collider(shape="sphere", size=(0.5,),
                                   density=800.0))
    ball.add_component(TC.Mesh(primitive="sphere", params={"radius": 0.5}))
    ball.add_component(TC.Material(albedo=(0.8, 0.2, 0.2), roughness=0.4))
    ground = s.create_entity("GroundVis")
    ground.add_component(TC.Transform())
    ground.add_component(TC.Mesh(primitive="quad", params={"half": 10.0}))
    sun = s.create_entity("Sun")
    sun.add_component(TC.DirectionalLight())
    return s.to_document()


DOCS = {"test_scene": _test_scene_doc(),
        "viewer_demo": viewer.build_demo_scene().to_document()}


def _build(scene_cls, comps, doc):
    """A scene of either package from a document, through the public
    entity API (as `load_yaml` reads one)."""
    s = scene_cls()
    for p in doc["planes"]:
        s.add_static_plane(p[:3], p[3], p[4], p[5])
    for ed in doc["entities"]:
        e = s.create_entity(ed["name"])
        for kind, data in ed["components"].items():
            for d in (data if kind in ("collider", "joint") else [data]):
                e.add_component(comps.from_plain(kind, dict(d)))
    return s


def _plain(scene, comps):
    """Every entity's name and components as plain, JSON-normal data."""
    rows = []
    for ent, _ in scene.view():
        row = {"name": ent.name}
        for kind in sorted(scene._components):
            v = ent.get(kind)
            if v is not None:
                row[kind] = ([comps.to_plain(c) for c in v]
                             if isinstance(v, list) else comps.to_plain(v))
        rows.append(row)
    return json.loads(json.dumps([rows, [list(p) for p in scene.planes]]))


@pytest.fixture(scope="module", params=sorted(DOCS))
def scenes(request):
    doc = DOCS[request.param]
    return (request.param, _build(JScene, JC, doc),
            _build(TScene, TC, doc))


def test_components_match_jax():
    """The same 15 components with the same fields and defaults."""
    import d3d12renderer_tpu.scene.components as jc

    assert sorted(TC._REGISTRY) == sorted(jc._REGISTRY)
    assert len(TC._REGISTRY) == 15
    for name, cls in TC._REGISTRY.items():
        jcls = jc._REGISTRY[name]
        assert [(f.name, f.type) for f in dataclasses.fields(cls)] == \
            [(f.name, f.type) for f in dataclasses.fields(jcls)], name
        assert TC.to_plain(cls()) == JC.to_plain(jcls()), name
        assert cls.component_name == name


def test_view_semantics_and_clone(scenes):
    """tests/test_scene.py's view and clone checks on both packages, plus
    delete_entity and a deep clone."""
    name, js, ts = scenes
    for s in (js, ts):
        kinds = [([e.id for e, _ in s.view(*k)]) for k in (
            (), ("transform",), ("transform", "rigid_body"),
            ("transform", "mesh"), ("collider",), ("joint",))]
        counts = [s.count(k) for k in ("collider", "joint", "mesh",
                                        "material", "rigid_body")]
        if s is js:
            want = (kinds, counts)
    assert (kinds, counts) == want
    both = list(ts.view("transform", "rigid_body"))
    if name == "test_scene":
        assert len(both) == 1 and both[0][0].name == "Ball"
        assert len(list(ts.view("transform", "mesh"))) == 2
        assert ts.count("collider") == 1
    c = ts.clone()
    extra = c.create_entity("Extra")
    ent = next(e for e, _ in c.view("transform"))
    c._components["transform"][ent.id] = dataclasses.replace(
        ent.get("transform"), position=(9.0, 9.0, 9.0))
    n = len(list(ts.view()))
    assert len(list(c.view())) == n + 1
    assert ts.entity(ent.id).get("transform").position != (9.0, 9.0, 9.0)
    c.delete_entity(extra)
    c.delete_entity(c.entity(ent.id))
    assert len(list(c.view())) == n - 1
    assert not c.entity(ent.id).has("transform")
    assert len(list(ts.view())) == n


def test_yaml_both_directions(scenes, tmp_path):
    """The port's file read by JAX, JAX's read by the port: equal
    components; the two files' texts equal."""
    _, js, ts = scenes
    tp, jp = str(tmp_path / "t.yaml"), str(tmp_path / "j.yaml")
    ts.save_yaml(tp)
    js.save_yaml(jp)
    assert open(tp).read() == open(jp).read()
    want = _plain(js, JC)
    assert _plain(JScene.load_yaml(tp), JC) == want
    assert _plain(TScene.load_yaml(jp), TC) == want
    assert _plain(TScene.load_yaml(tp), TC) == _plain(ts, TC) == want


def _touching(name, jstate):
    """The compiled state with the dynamic bodies lowered into contact
    with the plane and seeded velocities."""
    s = {f: np.asarray(getattr(jstate, f)).copy() for f in BODY_FIELDS}
    rng = np.random.default_rng(3)
    if name == "test_scene":
        s["pos"][0, 1] = 0.49
    else:
        # RedSphere r 0.8, MetalSphere r 0.6, BlueBox half 0.55; the post
        # and paddle stay.
        for i, y in zip(range(3), (0.79, 0.595, 0.545)):
            s["pos"][i, 1] = y
    s["vel"] = s["vel"] + rng.normal(0, 0.3, s["vel"].shape)
    s["omega"] = s["omega"] + rng.normal(0, 0.5, s["omega"].shape)
    return {k: v.astype(np.float32) for k, v in s.items()}


def test_compile_physics_and_one_step_match_jax(scenes):
    name, js, ts = scenes
    jarch, jstate, jmap = js.compile_physics()
    tarch, tstate, tmap = ts.compile_physics(device="cpu")
    assert tmap == jmap
    want, got = archetype_to_numpy(jarch), archetype_to_numpy(tarch)
    assert set(got) == set(want)
    for key in sorted(want):
        g, w = got[key], want[key]
        assert g.shape == w.shape and g.dtype.kind == w.dtype.kind, key
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=ARCH_TOL,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)
    for f in BODY_FIELDS:
        np.testing.assert_array_equal(getattr(tstate, f)[0].numpy(),
                                      np.asarray(getattr(jstate, f)))
    # One step (one 120 Hz substep), the bodies touching the plane; the
    # paddle's motor retargeted through the motor overrides.
    s = _touching(name, jstate)
    jmo = tuple(dict(t.params) for t in jarch.joints)
    tmo = tuple({k: v[None] for k, v in t.params.items()}
                for t in tarch.joints)
    for j, t in zip(jmo, tmo):
        j["motor_target"] = jnp.full_like(j["motor_target"], 6.0)
        t["motor_target"] = torch.full_like(t["motor_target"], 6.0)
    dt = 1.0 / 120.0
    want_st = jax.device_get(jax.jit(lambda st: jstep.physics_step(
        jarch, st, JSettings(), dt, motor_overrides=jmo or None)[0])(
            JBodyState(**{f: jnp.asarray(v) for f, v in s.items()})))
    got_st, contacts = tstep.physics_step(
        tarch, body_state_from_numpy({f: v[None] for f, v in s.items()},
                                     "cpu"),
        PhysicsSettings(), dt, motor_overrides=tmo or None)
    assert bool(contacts.active.any())
    for f, tol in BARS.items():
        err = np.abs(getattr(got_st, f)[0].numpy()
                     - np.asarray(getattr(want_st, f))).max()
        assert err <= tol, (f, err)


def test_compile_cloths_match_jax():
    doc = {"planes": [], "entities": [
        {"name": "Flag", "components": {
            "transform": {"position": [1.0, 2.0, -0.5]},
            "cloth": {"width": 1.5, "height": 1.0, "grid_x": 6,
                      "grid_y": 4, "total_mass": 2.0, "stiffness": 0.7,
                      "fix_top_row": True}}},
        {"name": "Sheet", "components": {
            "transform": {"position": [0.0, 1.0, 0.0]},
            "cloth": {"grid_x": 5, "grid_y": 5, "fix_top_row": False}}}]}
    jout = _build(JScene, JC, doc).compile_cloths()
    tout = _build(TScene, TC, doc).compile_cloths(device="cpu")
    assert [e for e, _, _ in tout] == [e for e, _, _ in jout]
    for (_, jp, jsn), (_, tp, tsn) in zip(jout, tout):
        np.testing.assert_array_equal(tp.inv_mass.numpy(),
                                      np.asarray(jp.inv_mass))
        for f in ("stiffness", "damping", "gravity_factor", "width",
                  "height"):
            assert getattr(tp, f) == getattr(jp, f), f
        for f in ("positions", "prev_positions", "velocities", "forces"):
            np.testing.assert_array_equal(getattr(tsn, f).numpy(),
                                          np.asarray(getattr(jsn, f)), f)


BVH_FIELDS = ("node_min", "node_max", "node_first", "node_count",
              "node_miss", "tri_v0", "tri_e1", "tri_e2", "tri_n0", "tri_n1",
              "tri_n2", "tri_uv0", "tri_uv1", "tri_uv2", "tri_material",
              "tri_valid")


def test_build_render_scene_matches_jax(scenes):
    """At the authored poses, and at body poses (each dynamic body moved
    and turned) through the mapping."""
    name, js, ts = scenes
    jarch, jstate, jmap = js.compile_physics()
    _, tstate, tmap = ts.compile_physics(device="cpu")
    rng = np.random.default_rng(8)
    n = np.asarray(jstate.pos).shape[0]
    pos = (np.asarray(jstate.pos) + rng.normal(0, 0.3, (n, 3))).astype(
        np.float32)
    rot = rng.normal(size=(n, 4)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
    moved_j = jstate.replace(pos=jnp.asarray(pos), rot=jnp.asarray(rot))
    moved_t = tstate.replace(pos=torch.as_tensor(pos)[None],
                             rot=torch.as_tensor(rot)[None])
    for (jb, jm), (tb, tm) in (((None, None), (None, None)),
                               ((moved_j, jmap), (moved_t, tmap))):
        want = js.build_render_scene(body_state=jb, mapping=jm)
        got = ts.build_render_scene(body_state=tb, mapping=tm, device="cpu")
        for f in BVH_FIELDS:
            g = getattr(got.bvh, f).numpy()
            w = np.asarray(getattr(want.bvh, f))
            assert g.shape == w.shape, f
            if w.dtype.kind == "f":
                np.testing.assert_allclose(g, w, rtol=0, atol=ARCH_TOL,
                                           err_msg=f)
            else:
                np.testing.assert_array_equal(g, w, err_msg=f)
        for f in ("albedo", "emissive", "roughness", "metallic"):
            np.testing.assert_array_equal(getattr(got.materials, f).numpy(),
                                          np.asarray(getattr(want.materials,
                                                             f)))
        for f in ("sun_direction", "sun_radiance", "zenith", "horizon",
                  "ground"):
            np.testing.assert_allclose(getattr(got.sky, f).numpy(),
                                       np.asarray(getattr(want.sky, f)),
                                       rtol=0, atol=ARCH_TOL, err_msg=f)
    rows = int(got.bvh.tri_valid.sum())
    assert rows > 1024 if name == "viewer_demo" else rows < 1024
