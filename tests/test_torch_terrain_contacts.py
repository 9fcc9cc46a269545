"""Terrain rows of the port's `generate_contacts` and whole substeps on
terrain against the JAX package on the CPU: examples/showcase.py's drop
(bilinear rows, colored contacts), tests/test_heightmap_mip.py's ridge
(triangles), every collider type on the ridge in both modes, and
examples/vehicle_terrain.py's scene (split-Jacobi); the fused route's
refusal of terrain rows.  Each JAX function runs under its own jit.  The
substeps run on the port's archetype as its builder makes it and as
`convert.archetype_from_numpy` makes it from JAX's.

Tolerances: contacts within 1e-5 (bodies and masks equal); one substep at
pos / rot 5e-6, vel 5e-5, omega 5e-4 (the port's substep bars).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3d12renderer_tpu.models.vehicle import build_vehicle as jax_build_vehicle
from d3d12renderer_tpu.models.vehicle import drive_overrides as jax_overrides
from d3d12renderer_tpu.physics import collide as jcollide
from d3d12renderer_tpu.physics import step as jstep
from d3d12renderer_tpu.physics import substep_pallas as jfused
from d3d12renderer_tpu.physics.builder import SceneBuilder as JaxSceneBuilder
from d3d12renderer_tpu.physics.types import PhysicsSettings as JaxSettings
from d3d12renderer_tpu_torch.convert import (archetype_from_numpy,
                                             archetype_to_numpy,
                                             body_state_from_numpy)
from d3d12renderer_tpu_torch.models import scenes
from d3d12renderer_tpu_torch.models.vehicle import build_vehicle, drive_overrides
from d3d12renderer_tpu_torch.physics import collide, step, substep_cuda
from d3d12renderer_tpu_torch.physics.builder import SceneBuilder
from d3d12renderer_tpu_torch.physics.types import PhysicsSettings
from d3d12renderer_tpu_torch.terrain import heightmap as hm

torch.set_num_threads(1)

BODY_FIELDS = ("pos", "rot", "vel", "omega", "force", "torque")
TOL = 1e-5


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _both(build, finalize=None):
    finalize = finalize or {}
    jb, tb = JaxSceneBuilder(), SceneBuilder()
    jout, tout = build(jb, "jax"), build(tb, "port")
    jarch, jstate = jb.finalize(**finalize)
    tarch, tstate = tb.finalize(device="cpu", **finalize)
    return (jarch, jstate, jout), (tarch, tstate, tout)


def _port_state(jstate):
    return body_state_from_numpy(
        {f: np.asarray(getattr(jstate, f))[None] for f in BODY_FIELDS},
        device="cpu")


def _drop_scene(b, _):
    scenes.add_terrain_drop(b, _DROP_HEIGHTS)


def _ridge_scene(b, _):
    scenes.add_ridge(b)


def _hull_scene(b, _):
    """A hull, a box, a capsule, a cylinder and a sphere on the ridge with
    a plane below, in one no-collide group: every plane-narrowphase kind in
    the terrain segments, no pair rows."""
    b.add_static_plane((0.0, 1.0, 0.0), -1.0)
    group = b.new_no_collide_group()
    rng = np.random.default_rng(2)
    for i, add in enumerate((
            lambda k: b.add_hull_collider(k, rng.normal(0, 0.3, (16, 3))),
            lambda k: b.add_box_collider(k, (0.3, 0.2, 0.25)),
            lambda k: b.add_capsule_collider(k, 0.2, 0.3),
            lambda k: b.add_cylinder_collider(k, 0.25, 0.2),
            lambda k: b.add_sphere_collider(k, 0.3))):
        body = b.add_body((2.0 + 1.0 * i, 1.9, 2.5 + 0.7 * i))
        b.set_no_collide_group(body, group)
        add(body)
    b.add_terrain(scenes.ridge_heights(), origin=(0.0, 0.0, 0.0),
                  cell_size=1.0, friction=0.6, restitution=0.1)


_DROP_HEIGHTS = scenes.terrain_drop_heights()


def _near_ground(jstate, arch_heights, origin, cell, lift, rng):
    """The state's bodies put `lift` above the bilinear surface, tilted and
    moving, so that their terrain rows touch."""
    pos = np.asarray(jstate.pos).copy()
    y, _ = hm.sample_height_bilinear(
        torch.as_tensor(arch_heights), origin, cell,
        torch.as_tensor(pos[:, 0]), torch.as_tensor(pos[:, 2]))
    pos[:, 1] = y.numpy() + lift
    q = np.asarray(jstate.rot) + rng.normal(0, 0.2, (len(pos), 4))
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    return jstate.replace(
        pos=jnp.asarray(pos), rot=jnp.asarray(q),
        vel=jnp.asarray(rng.normal(0, 0.5, pos.shape).astype(np.float32)),
        omega=jnp.asarray(rng.normal(0, 1.0, pos.shape).astype(np.float32)))


_CONTACT_CASES = {
    "drop_bilinear": (_drop_scene, {}, _DROP_HEIGHTS,
                      scenes.TERRAIN_DROP_ORIGIN, scenes.TERRAIN_DROP_CELL,
                      0.35),
    "ridge_triangles": (_ridge_scene, dict(terrain_collision="triangles"),
                        scenes.ridge_heights(), (0.0, 0.0, 0.0), 1.0, None),
    "shapes_bilinear": (_hull_scene, {}, scenes.ridge_heights(),
                        (0.0, 0.0, 0.0), 1.0, 0.2),
    "shapes_triangles": (_hull_scene, dict(terrain_collision="triangles"),
                         scenes.ridge_heights(), (0.0, 0.0, 0.0), 1.0, 0.2),
}


@pytest.fixture(scope="module", params=sorted(_CONTACT_CASES))
def terrain_case(request):
    build, fin, h, origin, cell, lift = _CONTACT_CASES[request.param]
    (jarch, jstate, _), (tarch, _, _) = _both(build, fin)
    if lift is None:    # the ridge's box, its bottom 5 cm into the crest
        pos = np.asarray(jstate.pos).copy()
        pos[0, 1] = 2.05
        jstate = jstate.replace(pos=jnp.asarray(pos))
    else:
        jstate = _near_ground(jstate, h, origin, cell, lift,
                              np.random.default_rng(4))
    return request.param, jarch, jstate, tarch


def test_terrain_rows_of_generate_contacts_match_jax(terrain_case):
    """Plane rows, terrain rows (bilinear or triangles), buckets: masks
    equal, the rest within 1e-5."""
    name, jarch, jstate, tarch = terrain_case
    want = jax.device_get(jax.jit(
        lambda s: jcollide.generate_contacts(jarch, s))(jstate))
    got = collide.generate_contacts(tarch, _port_state(jstate))
    q, q2 = tarch.vs_plane_collider.shape[0], tarch.vs_terrain_collider.shape[0]
    active = np.asarray(want.active)
    assert active[q:q + q2].any(), name
    for f in ("body_a", "body_b", "pmask", "active"):
        g = _np(getattr(got, f))
        np.testing.assert_array_equal(g.reshape(np.shape(getattr(want, f))),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("normal", "point", "depth", "friction", "restitution"):
        np.testing.assert_allclose(_np(getattr(got, f))[0],
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=TOL, err_msg=f)


def _check_substep(jarch, jstate, tarch, jsettings, tsettings, dt,
                   j_overrides=None, t_overrides=None):
    want, _ = jax.jit(lambda s: jstep.physics_substep(
        jarch, s, dt, jsettings, j_overrides))(jstate)
    from_jax = archetype_from_numpy(archetype_to_numpy(jarch), device="cpu")
    for source, arch in (("builder", tarch), ("from_jax", from_jax)):
        got, _ = step.physics_substep(arch, _port_state(jstate), dt,
                                      tsettings, t_overrides)
        for f, tol in (("pos", 5e-6), ("rot", 5e-6), ("vel", 5e-5),
                       ("omega", 5e-4)):
            np.testing.assert_allclose(getattr(got, f)[0].numpy(),
                                       np.asarray(getattr(want, f)), rtol=0,
                                       atol=tol, err_msg=f"{source} {f}")


def test_drop_substep_matches_jax():
    """examples/showcase.py's drop near the ground, colored contacts (the
    plain colored solve on the CPU; the fused route refuses terrain)."""
    (jarch, jstate, _), (tarch, _, _) = _both(_drop_scene)
    jstate = _near_ground(jstate, _DROP_HEIGHTS, scenes.TERRAIN_DROP_ORIGIN,
                          scenes.TERRAIN_DROP_CELL, 0.4,
                          np.random.default_rng(8))
    _check_substep(jarch, jstate, tarch,
                   JaxSettings(fused_substep="off", solver_backend="xla"),
                   PhysicsSettings(), 1 / 120)


def test_ridge_substep_matches_jax():
    (jarch, jstate, _), (tarch, _, _) = _both(
        _ridge_scene, dict(terrain_collision="triangles"))
    pos = np.asarray(jstate.pos).copy()
    pos[0, 1] = 2.06
    jstate = jstate.replace(pos=jnp.asarray(pos), vel=jnp.asarray(
        np.array([[0.1, -0.5, 0.05]], np.float32)))
    _check_substep(jarch, jstate, tarch,
                   JaxSettings(fused_substep="off", solver_backend="xla"),
                   PhysicsSettings(), 1 / 120)


def test_vehicle_on_terrain_substep_matches_jax():
    """examples/vehicle_terrain.py's scene, one split-Jacobi substep at 60
    Hz with the throttle on, the vehicle lowered 0.6 m (it is built with
    its wheels ~0.55 m above the ground) so that wheels' terrain rows
    touch."""
    heights = scenes.vehicle_terrain_heights()

    def build(b, pkg):
        start = scenes.add_vehicle_terrain(b, heights)
        return (jax_build_vehicle if pkg == "jax" else build_vehicle)(
            b, position=start)

    (jarch, jstate, jinfo), (tarch, _, tinfo) = _both(build)
    jstate = jstate.replace(pos=jstate.pos - jnp.array([0.0, 0.6, 0.0]))
    jset = JaxSettings(frame_rate=60, contact_mode="split_jacobi")
    tset = PhysicsSettings(frame_rate=60, contact_mode="split_jacobi")
    jov = jax_overrides(jarch, jinfo, throttle_velocity=10.0,
                        steering_angle=0.0)
    tov = drive_overrides(tarch, tinfo, throttle_velocity=10.0,
                          steering_angle=0.0)
    contacts = collide.generate_contacts(tarch, _port_state(jstate))
    q = tarch.vs_plane_collider.shape[0]
    assert int(contacts.active[0, q:q + tarch.vs_terrain_collider.shape[0]]
               .sum()) >= 2
    _check_substep(jarch, jstate, tarch, jset, tset, 1 / 60, jov, tov)


@pytest.mark.parametrize("build,finalize,reason", [
    (_drop_scene, {}, "terrain rows"),
    (_ridge_scene, dict(terrain_collision="triangles"), "terrain rows"),
], ids=["drop", "ridge"])
def test_fused_route_refuses_terrain_rows(build, finalize, reason):
    """support_reason refuses terrain rows, as JAX's does."""
    (jarch, _, _), (tarch, _, _) = _both(build, finalize)
    assert jfused.support_reason(jarch, JaxSettings()) == reason
    assert substep_cuda.support_reason(tarch, PhysicsSettings()) == reason


