"""The port's gear-train vehicle (BASELINE config 4) against the JAX package
on the CPU: the archetype both builders compile from `build_vehicle`, the
motor overrides, the contact table (capsule teeth, cylinder wheels through
GJK, plane rows) and one whole split-Jacobi substep with the throttle on.

The state is the vehicle as built, lowered until its wheels sink 3 cm into
the ground, with seeded velocity noise (B = 2 scenes); in scene 1 the left
front wheel is pushed in against the chassis, so that plane, tooth and
GJK rows all touch.
Tolerances: integers exact, floats of the archetype 1e-6, manifolds 1e-5,
one substep pos/rot 5e-6, vel 5e-5, omega 5e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3d12renderer_tpu.models import vehicle as jvehicle
from d3d12renderer_tpu.physics import collide as jcollide
from d3d12renderer_tpu.physics import step as jstep
from d3d12renderer_tpu.physics.builder import SceneBuilder as JaxBuilder
from d3d12renderer_tpu.physics.types import BodyState as JaxBodyState
from d3d12renderer_tpu.physics.types import PhysicsSettings as JaxSettings
from d3d12renderer_tpu_torch.convert import (archetype_to_numpy,
                                             body_state_from_numpy)
from d3d12renderer_tpu_torch.entry import vehicle_entry
from d3d12renderer_tpu_torch.models import vehicle
from d3d12renderer_tpu_torch.physics import collide, step
from d3d12renderer_tpu_torch.physics.builder import SceneBuilder
from d3d12renderer_tpu_torch.physics.types import (SHAPE_CYLINDER,
                                                   PhysicsSettings)

torch.set_num_threads(1)

B = 2
DT = 1.0 / 60.0
THROTTLE = 10.0
FIELDS = ("pos", "rot", "vel", "omega", "force", "torque")


@pytest.fixture(scope="module")
def both():
    jb, tb = JaxBuilder(), SceneBuilder()
    infos = []
    for b, mod in ((jb, jvehicle), (tb, vehicle)):
        b.add_static_plane((0.0, 1.0, 0.0), 0.0, friction=1.0)
        infos.append(mod.build_vehicle(b, position=(0.0, 0.85, 0.0)))
    jarch, jstate0 = jb.finalize()
    tarch, _ = tb.finalize(device="cpu")
    rng = np.random.default_rng(4)
    s = {f: np.repeat(np.asarray(getattr(jstate0, f))[None], B, 0)
         for f in FIELDS}
    # Lower the vehicle until its wheels (cylinders on horizontal axes, the
    # lowest colliders) sink 3 cm in.
    wpos, _ = collide.collider_world_poses(tarch,
                                           body_state_from_numpy(s, "cpu"))
    wheels = tarch.col_type == SHAPE_CYLINDER
    drop = 0.03 + float((wpos[0, wheels, 1]
                         - tarch.col_size[wheels, 0]).min())
    s["pos"] = s["pos"] - np.float32([0.0, drop, 0.0])
    # Scene 1: the left front wheel pushed in against the chassis box and
    # the rack teeth (the box-cylinder and capsule-cylinder rows, GJK).
    s["pos"][1, infos[1].bodies["left_front_wheel"], 0] += 0.97
    s["vel"] = rng.normal(0, 0.2, s["vel"].shape)
    s["omega"] = rng.normal(0, 0.5, s["omega"].shape)
    s = {k: v.astype(np.float32) for k, v in s.items()}
    jov = jvehicle.drive_overrides(jarch, infos[0], THROTTLE, 0.1)
    tov = vehicle.drive_overrides(tarch, infos[1], THROTTLE, 0.1, batch=B)
    return dict(jarch=jarch, tarch=tarch, jinfo=infos[0], tinfo=infos[1],
                state=s, jov=jov, tov=tov)


def test_vehicle_archetype_matches_jax(both):
    want = archetype_to_numpy(both["jarch"])
    got = archetype_to_numpy(both["tarch"])
    assert set(got) == set(want)
    for name in sorted(want):
        g, w = got[name], want[name]
        assert g.shape == w.shape and g.dtype.kind == w.dtype.kind, name
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    arch = both["tarch"]
    assert arch.num_bodies == 16 and arch.num_colliders == 86
    assert {(b.type_a, b.type_b): b.collider_a.shape[0]
            for b in arch.contact_buckets} == {(1, 1): 1072, (1, 3): 86,
                                               (2, 3): 2}
    assert arch.vs_plane_collider.shape[0] == 86
    assert sorted(t.kind for t in arch.joints) == ["ball", "fixed", "hinge",
                                                   "slider"]
    assert vars(both["tinfo"]) == vars(both["jinfo"])


def test_drive_overrides_match_jax(both):
    jov, tov = both["jov"], both["tov"]
    assert len(tov) == len(jov)
    for j, t in zip(jov, tov):
        assert (j is None) == (t is None)
        if j is not None:
            assert set(t) == set(j) == {"motor_target"}
            want = np.asarray(j["motor_target"])
            assert t["motor_target"].shape == (B,) + want.shape
            for s in range(B):
                np.testing.assert_array_equal(t["motor_target"][s].numpy(),
                                              want)
    row = both["tinfo"].hinge_row
    k = next(k for k, t in enumerate(both["tarch"].joints) if t.kind == "hinge")
    assert float(tov[k]["motor_target"][0, row["motor"]]) == THROTTLE


def test_drive_overrides_per_scene_match_jax(both):
    """One throttle per scene: each scene's row equals JAX's overrides at
    that scene's throttle."""
    throttles = [10.0, 8.0, 0.0]
    tov = vehicle.drive_overrides(both["tarch"], both["tinfo"], throttles,
                                  0.0, batch=len(throttles))
    k = next(k for k, t in enumerate(both["tarch"].joints) if t.kind == "hinge")
    for s, throttle in enumerate(throttles):
        want = jvehicle.drive_overrides(both["jarch"], both["jinfo"],
                                        throttle, 0.0)[k]["motor_target"]
        np.testing.assert_array_equal(tov[k]["motor_target"][s].numpy(),
                                      np.asarray(want))


@pytest.fixture(scope="module")
def stepped(both):
    jarch = both["jarch"]
    js = JaxSettings(frame_rate=60, contact_mode="split_jacobi")
    jst = JaxBodyState(**{f: jnp.asarray(v) for f, v in both["state"].items()})

    def one(st):
        ct = jcollide.generate_contacts(jarch, st)
        new, _ = jstep.physics_substep(jarch, st, DT, js,
                                       motor_overrides=both["jov"])
        return ct, new

    want_ct, want = jax.device_get(jax.jit(jax.vmap(one))(jst))
    tst = body_state_from_numpy(both["state"], device="cpu")
    got, got_ct = step.physics_substep(
        both["tarch"], tst, DT,
        PhysicsSettings(frame_rate=60, contact_mode="split_jacobi"),
        motor_overrides=both["tov"])
    return dict(want=want, got=got, want_ct=want_ct, got_ct=got_ct)


def _close(got, want, atol, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= atol, f"{what}: max |err| {err:.3e} > {atol}"


def test_vehicle_contacts_match_jax(both, stepped):
    """Plane rows (chassis box, teeth, wheel cylinders), tooth pairs and the
    GJK rows of the wheels: masks equal, manifolds 1e-5."""
    want, got = stepped["want_ct"], stepped["got_ct"]
    np.testing.assert_array_equal(got.pmask.numpy(), np.asarray(want.pmask))
    pm = np.asarray(want.pmask)
    act = np.asarray(want.active)
    _close(got.normal.numpy()[act], np.asarray(want.normal)[act], 1e-5,
           "normal")
    _close(got.point.numpy()[pm], np.asarray(want.point)[pm], 1e-5, "point")
    _close(got.depth.numpy()[pm], np.asarray(want.depth)[pm], 1e-5, "depth")
    # Rows by kind: plane rows, capsule pairs, GJK pairs all touch.
    q = both["tarch"].vs_plane_collider.shape[0]
    assert act[:, :q].sum() >= 2 * B and act[:, q:q + 1072].sum() > 0
    assert act[:, q + 1072:].sum() > 0


@pytest.mark.parametrize("field,atol", [
    ("pos", 5e-6), ("rot", 5e-6), ("vel", 5e-5), ("omega", 5e-4),
])
def test_vehicle_substep_matches_jax(stepped, field, atol):
    _close(getattr(stepped["got"], field), getattr(stepped["want"], field),
           atol, field)


def test_vehicle_entry_runs():
    """`vehicle_entry` on the CPU: two frames, finite, the motor gear
    spinning up."""
    fn, (arch, info, state) = vehicle_entry(device="cpu", batch=2, steps=2)
    state, contacts = fn(state)
    assert state.pos.shape == (2, 16, 3)
    assert all(bool(torch.isfinite(getattr(state, f)).all())
               for f in ("pos", "rot", "vel", "omega"))
    assert contacts.active.any()
    assert float(state.omega[0, info.bodies["motor_gear"]].norm()) > 0.1
