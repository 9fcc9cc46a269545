"""`entry.flythrough_entry` (examples/flythrough.py's path) against the JAX
package on the CPU: the pile's set-up, one substep of the pile settled for
`entry.FLYTHROUGH_SETTLE_FRAMES` frames (in JAX, under jit) with contact
rows active, the per-frame instance retransform, and three filmed frames
under the orbiting camera at 64x64 (the raster primary, TAA fed by the
previous frame's camera) with JAX's per-frame jitter
(`jax.random.uniform(PRNGKey(f), (2,))`, as its `render_gbuffer` draws
it) handed to the port.  The cascades are cut to 32^2 on both sides: the
plain closest hit over the pile's 2,560 rows takes seconds a frame at
256^2 on the CPU.

Tolerances: the substep at pos / rot 5e-6, vel 5e-5, omega 5e-4 (the
port's substep bars); the retransformed soup within 2e-6 (two ulps at the
pile's heights of up to 14 m: XLA fuses the quaternion rotation's products
into FMAs); frames with at least 99% of
pixels within 1e-3 and the mean error under 1e-3.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3d12renderer_tpu.physics import step as jstep
from d3d12renderer_tpu.physics.builder import SceneBuilder as JaxSceneBuilder
from d3d12renderer_tpu.physics.types import PhysicsSettings as JaxSettings
from d3d12renderer_tpu.render import mesh as jmesh
from d3d12renderer_tpu.render.camera import look_at as jlook_at
from d3d12renderer_tpu.render.instances import build_instanced as jinstanced
from d3d12renderer_tpu.render.instances import retransform as jretransform
from d3d12renderer_tpu.render.lights import make_point_lights as jlights
from d3d12renderer_tpu.render.pathtracer import Materials as JaxMaterials
from d3d12renderer_tpu.render.pathtracer import Scene as JaxScene
from d3d12renderer_tpu.render.pathtracer import default_sky as jsky
from d3d12renderer_tpu.render.pipeline import RendererSettings as JaxRS
from d3d12renderer_tpu.render.pipeline import initial_frame_state as jfs
from d3d12renderer_tpu.render.pipeline import (
    render_frame_with_shadows as jrender)
from d3d12renderer_tpu_torch import entry
from d3d12renderer_tpu_torch.convert import body_state_from_numpy
from d3d12renderer_tpu_torch.models import scenes
from d3d12renderer_tpu_torch.physics import collide, step, substep_cuda
from d3d12renderer_tpu_torch.physics.types import PhysicsSettings
from d3d12renderer_tpu_torch.render.instances import retransform

torch.set_num_threads(1)

BODY_FIELDS = ("pos", "rot", "vel", "omega", "force", "torque")
STATE_TOL = (("pos", 5e-6), ("rot", 5e-6), ("vel", 5e-5), ("omega", 5e-4))
SOUP_TOL = 2e-6
W = H = 64
FRAMES = 3
SHADOW_RES = 32
PIXEL_TOL = 1e-3
SHARE = 0.99
MEAN_TOL = 1e-3


@pytest.fixture(scope="module")
def pile():
    """Both packages' pile, and JAX's state after the settling frames
    (2 substeps of 1/120 s a frame, under jit)."""
    jb = JaxSceneBuilder()
    kinds = scenes.add_flythrough_pile(jb)
    jarch, jstate = jb.finalize()
    world = entry.flythrough_world("cpu")
    frame = jax.jit(lambda s: jstep.physics_step(
        jarch, s, JaxSettings(), entry.FLYTHROUGH_FRAME_DT,
        entry.FLYTHROUGH_SUBSTEPS)[0])
    settled = jstate
    for _ in range(entry.FLYTHROUGH_SETTLE_FRAMES):
        settled = frame(settled)
    return jarch, jstate, jax.device_get(settled), kinds, world, frame


def _port(jstate):
    return body_state_from_numpy(
        {f: np.asarray(getattr(jstate, f))[None] for f in BODY_FIELDS},
        device="cpu")


def test_pile_matches_jax(pile):
    """The same bodies and colliders from the shared scene function, the
    pile outside the fused kernel's family (its pair rows): on the card
    each substep is one colored-solver launch."""
    _, jstate, _, kinds, world, _ = pile
    assert kinds == world.kinds and kinds.count("sphere") == 6
    for f in ("pos", "rot"):
        np.testing.assert_array_equal(getattr(world.state, f)[0].numpy(),
                                      np.asarray(getattr(jstate, f)))
    assert substep_cuda.support_reason(world.arch,
                                       PhysicsSettings()) == "pair buckets"


def test_contact_substep_matches_jax(pile):
    """One 120 Hz substep of the settled pile, contact rows active."""
    jarch, _, settled, _, world, _ = pile
    tstate = _port(settled)
    active = int(collide.generate_contacts(world.arch, tstate).active.sum())
    assert active > 0
    want = jax.jit(lambda s: jstep.physics_step(
        jarch, s, JaxSettings(), 1 / 120, 1)[0])(settled)
    with torch.inference_mode():
        got, _ = step.physics_step(world.arch, tstate, PhysicsSettings(),
                                   1 / 120, 1)
    for f, tol in STATE_TOL:
        np.testing.assert_allclose(getattr(got, f)[0].numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=tol, err_msg=f)


def _jax_instances():
    meshes = [(jmesh.box((scenes.FLYTHROUGH_BOX_HALF,) * 3), 1),
              (jmesh.ico_sphere(scenes.FLYTHROUGH_SPHERE_RADIUS,
                                entry.FLYTHROUGH_SPHERE_SUBDIV), 2),
              (jmesh.quad(half=entry.FLYTHROUGH_GROUND_HALF), 0)]
    return meshes


def _poses(state, batched):
    pos = np.asarray(state.pos)[0 if batched else slice(None)]
    rot = np.asarray(state.rot)[0 if batched else slice(None)]
    return (np.concatenate([pos, np.zeros((1, 3), np.float32)]),
            np.concatenate([rot, np.array([[0, 0, 0, 1]], np.float32)]))


def test_retransform_matches_jax(pile):
    """The per-frame BVH of the settled pile: the posed soup, materials
    and valid rows of JAX's instanced shell, and one leaf over every row
    (the port's shell: its ray dispatch walks the node table)."""
    _, _, settled, kinds, world, _ = pile
    jscene = jinstanced(_jax_instances(),
                        [0 if k == "box" else 1 for k in kinds] + [2])
    pos, rot = _poses(settled, False)
    want = jretransform(jscene, jnp.asarray(pos), jnp.asarray(rot))
    got = retransform(world.instances, torch.as_tensor(pos),
                      torch.as_tensor(rot))
    rows = got.tri_v0.shape[0]
    assert rows == np.asarray(want.tri_v0).shape[0] == 2560
    for f in ("tri_material", "tri_valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    for f in ("tri_v0", "tri_e1", "tri_e2", "tri_n0", "tri_n1", "tri_n2",
              "tri_uv0", "tri_uv1", "tri_uv2"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=SOUP_TOL, err_msg=f)
    assert got.node_count.tolist() == [rows] and got.node_first.tolist() == [0]
    valid = got.tri_valid
    corners = torch.cat([got.tri_v0[valid], (got.tri_v0 + got.tri_e1)[valid],
                         (got.tri_v0 + got.tri_e2)[valid]])
    assert bool((corners >= got.node_min - 1e-5).all())
    assert bool((corners <= got.node_max + 1e-5).all())


def _jax_frames(settled, kinds, frame, jitter_keys):
    """examples/flythrough.py:106-145 with the raster primary, from the
    settled state, cascades at SHADOW_RES; `frame` is the jitted physics
    frame."""
    iscene = jinstanced(_jax_instances(),
                        [0 if k == "box" else 1 for k in kinds] + [2])
    mats = JaxMaterials(
        albedo=jnp.array(entry.FLYTHROUGH_ALBEDO),
        emissive=jnp.zeros((3, 3)),
        roughness=jnp.array(entry.FLYTHROUGH_ROUGHNESS),
        metallic=jnp.zeros(3))
    sky = jsky()
    light = entry.FLYTHROUGH_LIGHT
    lights = jlights(light["positions"], light["colors"], light["radii"])

    @jax.jit
    def pose(state):
        pos = jnp.concatenate([state.pos, jnp.zeros((1, 3))])
        rot = jnp.concatenate([state.rot, jnp.array([[0.0, 0.0, 0.0, 1.0]])])
        return jretransform(iscene, pos, rot)

    render = jax.jit(lambda scene, cam, prev, st, k: jrender(
        scene, cam, W, H, JaxRS(primary="raster"),
        shadow_resolution=SHADOW_RES, point_lights=lights, frame_state=st,
        prev_camera=prev, key=k))

    def camera_at(f):
        th = 2 * math.pi * f / FRAMES
        eye = (6.5 * math.cos(th), 2.6 + 1.2 * math.sin(2 * th),
               6.5 * math.sin(th))
        return jlook_at(eye=eye, target=(0.0, 0.9, 0.0), aspect=W / H,
                        v_fov=math.radians(48))

    state, fstate, prev, out = settled, jfs(W, H), None, []
    for f in range(FRAMES):
        state = frame(state)
        bvh = pose(state)
        cam = camera_at(f)
        ldr, fstate, _ = render(JaxScene(bvh=bvh, materials=mats, sky=sky),
                                cam, prev or cam, fstate, jitter_keys[f])
        prev = cam
        out.append(np.asarray(ldr))
    return out, jax.device_get(state)


def test_three_frames_match_jax(pile, monkeypatch):
    """Three filmed frames from the settled pile: the orbiting camera (its
    previous pose feeding TAA's motion vectors), the cascades re-rendered
    every frame from the moving bodies, the point light; and the final
    bodies."""
    _, _, settled, kinds, _, frame = pile
    keys = [jax.random.PRNGKey(f) for f in range(FRAMES)]
    want, want_state = _jax_frames(settled, kinds, frame, keys)
    monkeypatch.setattr(entry, "FLYTHROUGH_SHADOW_RESOLUTION", SHADOW_RES)
    jitters = [torch.as_tensor(np.array(jax.random.uniform(k, (2,))))
               for k in keys]
    got = entry.flythrough_entry(device="cpu", width=W, height=H,
                                 frames=FRAMES, settle_frames=0,
                                 state=_port(settled), jitters=jitters)
    assert len(got["frames"]) == FRAMES and len(got["frame_ms"]) == FRAMES
    assert int(got["frame_state"].frame_index) == FRAMES
    for i, (ldr, ref) in enumerate(zip(got["frames"], want)):
        assert ldr.shape == (H, W, 3) and bool(torch.isfinite(ldr).all())
        err = np.abs(ldr.numpy() - ref).max(-1)
        share = (err <= PIXEL_TOL).mean()
        assert share >= SHARE and err.mean() < MEAN_TOL, (i, share,
                                                          err.mean())
    # The frames differ: the camera moves.
    assert float((got["frames"][0] - got["frames"][-1]).abs().mean()) > 1e-3
    for f, tol in STATE_TOL:
        np.testing.assert_allclose(
            getattr(got["state"], f)[0].numpy(),
            np.asarray(getattr(want_state, f)), rtol=0,
            atol=tol * 2 * FRAMES, err_msg=f)
