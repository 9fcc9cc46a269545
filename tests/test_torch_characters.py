"""Skinned characters on the port against the JAX package, on the CPU:
the ragdoll fitted from the generated character's skeleton and skin
(`classify_joints`, `analyze_limbs`, `from_fbx_asset`, one substep of the
fitted archetype at the physics tests' bars: pos / rot 5e-6, vel 5e-5, omega 5e-4),
`character_ragdoll_entry`, kernel #2's source as host C++ against the
plain step on the landed heap, and `character_entry` as a whole at 256x128
(2 coarse characters, the atrium swapped for a small scene as
tests/test_torch_pipeline.py does; at 128x64 the far characters' and
prop's silhouette pixels, where the two rasterizers' float32 planes may
pick another triangle, and the bloom around them, are 1.2% of the frame) against JAX's `build_frame_bvh`,
`render_frame`, `draw_outlines` and `rasterize_lines` on the same arrays,
2 frames with the port's occlusion feedback carried (JAX's frame takes its
pair path): at least 99% of pixels within 1e-3, mean error below 1e-4."""

import ctypes
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3d12renderer_tpu.animation import animation as janim
from d3d12renderer_tpu.assets import fbx as jfbx
from d3d12renderer_tpu.models import ragdoll as jrd
from d3d12renderer_tpu.physics import step as jstep
from d3d12renderer_tpu.physics.builder import SceneBuilder as JaxSceneBuilder
from d3d12renderer_tpu.physics.types import PhysicsSettings as JaxSettings
from d3d12renderer_tpu.render import bvh as jbvh
from d3d12renderer_tpu.render import camera as jcam
from d3d12renderer_tpu.render import debug_viz as jdbg
from d3d12renderer_tpu.render import instances as jinst
from d3d12renderer_tpu.render import mesh as jmesh
from d3d12renderer_tpu.render import pathtracer as jpt
from d3d12renderer_tpu.render import pipeline as jpipe
from d3d12renderer_tpu.render import shadows as jshadows
from d3d12renderer_tpu.render import skinned_instances as jsi
from d3d12renderer_tpu_torch import convert, entry
from d3d12renderer_tpu_torch.assets import fbx as tfbx
from d3d12renderer_tpu_torch.models import ragdoll as trd
from d3d12renderer_tpu_torch.ops import image, raster
from d3d12renderer_tpu_torch.physics import step, substep_cuda
from d3d12renderer_tpu_torch.physics.builder import SceneBuilder
from d3d12renderer_tpu_torch.physics.types import PhysicsSettings

from tests.test_torch_fused import _HARNESS as FUSED_HARNESS
from tests.test_torch_pipeline import MEAN_TOL, PIXEL_TOL, SHARE, _meshes
from tests.torch_host_build import build_host

torch.set_num_threads(1)
BODY_FIELDS = ("pos", "rot", "vel", "omega", "force", "torque")
W, H = 256, 128
MAPS = 64


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """The generated character (full size: the ragdoll fit reads its
    vertex cloud), read by both packages."""
    path = str(tmp_path_factory.mktemp("character") / "character.fbx")
    entry.write_character(path)
    return jfbx.load_fbx(path), tfbx.load_fbx(path)


def test_joints_classify_into_every_limb(assets):
    """The 19-joint rig classifies into all 14 limb types, as JAX's."""
    _, ta = assets
    skel = ta.skeletons[0]
    types = trd.classify_joints(skel.names, skel.parents)
    assert types == jrd.classify_joints(skel.names, skel.parents)
    assert set(types) == set(trd.LIMB_TYPES)
    extra = ["Hips", "LeftUpLeg", "l_forearm", "arm.R", "RightToeBase",
             "neck_01", "spine.003"]
    assert trd.classify_joints(extra, [-1, 0, 0, 0, 0, 0, 0]) == \
        jrd.classify_joints(extra, [-1, 0, 0, 0, 0, 0, 0])


def test_limb_fits_match_jax(assets):
    """`analyze_limbs` on the character's skin: every LimbFit within 1e-5,
    the bind world transforms equal."""
    ja, ta = assets
    args = []
    for a in (ja, ta):
        s, k, msh = a.skeletons[0], a.mesh_skin[0], a.meshes[0]
        args.append((s.names, s.parents, s.bind_local_pos, s.bind_local_rot,
                     msh.positions, k.joint_indices, k.joint_weights))
    jf, jt, (jwp, jwr) = jrd.analyze_limbs(*args[0])
    tf, tt, (twp, twr) = trd.analyze_limbs(*args[1])
    assert jt == tt and sorted(jf) == sorted(tf) == sorted(trd.LIMB_TYPES)
    np.testing.assert_array_equal(twp, jwp)
    np.testing.assert_array_equal(twr, jwr)
    for limb, f in tf.items():
        g = jf[limb]
        assert f.joint == g.joint
        np.testing.assert_allclose(
            [f.min_y, f.max_y, f.radius, f.x_off, f.z_off],
            [g.min_y, g.max_y, g.radius, g.x_off, g.z_off], rtol=0,
            atol=1e-5)


def _fitted(builder_cls, rd, asset, **finalize):
    b = builder_cls()
    b.add_static_plane((0.0, 1.0, 0.0), 0.0, friction=1.0)
    fitted = rd.from_fbx_asset(b, asset)
    return fitted, b.finalize(**finalize)


def test_fitted_ragdoll_steps_like_jax(assets):
    """`from_fbx_asset`: 14 capsule bodies, 4 hinges and 9 cone-twists,
    the archetypes equal (1e-6); the port's fused family takes it; one
    substep of the fitted ragdoll lowered onto the plane with seeded
    velocities (the unfused step: the plain colored solve) against JAX's
    unfused XLA substep."""
    ja, ta = assets
    jfit, (jarch, jstate) = _fitted(JaxSceneBuilder, jrd, ja)
    tfit, (tarch, _) = _fitted(SceneBuilder, trd, ta, device="cpu")
    assert (len(tfit.bodies), len(tfit.hinge_joint_ids),
            len(tfit.cone_twist_joint_ids)) == (14, 4, 9)
    assert tfit.joint_limbs == jfit.joint_limbs
    assert tfit.bodies == jfit.bodies
    assert tfit.hinge_joint_ids == jfit.hinge_joint_ids
    assert tfit.cone_twist_joint_ids == jfit.cone_twist_joint_ids
    want_flat = convert.archetype_to_numpy(jarch)
    got_flat = convert.archetype_to_numpy(tarch)
    assert sorted(want_flat) == sorted(got_flat)
    for k, v in want_flat.items():
        np.testing.assert_allclose(got_flat[k], v, rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    assert substep_cuda.support_reason(
        tarch, PhysicsSettings(frame_rate=entry.RAGDOLL_FRAME_RATE)) is None
    rng = np.random.default_rng(5)
    n = np.asarray(jstate.pos).shape[0]
    pos0 = np.array(jstate.pos)
    lowest = entry.fitted_lowest(tfit, tarch.local_cog, torch.as_tensor(pos0),
                                 torch.as_tensor(np.array(jstate.rot)))
    # The lowest capsule 1 cm into the plane.
    pos = pos0 - np.array([0.0, lowest + 0.01, 0.0], np.float32)
    jstate = jstate.replace(
        pos=jnp.asarray(pos),
        vel=jnp.asarray(rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)),
        omega=jnp.asarray(rng.uniform(-1, 1, (n, 3)).astype(np.float32)))
    dt = 1.0 / entry.RAGDOLL_FRAME_RATE
    want, _ = jax.jit(lambda s: jstep.physics_substep(
        jarch, s, dt, JaxSettings(frame_rate=entry.RAGDOLL_FRAME_RATE,
                                  fused_substep="off",
                                  solver_backend="xla")))(jstate)
    got, contacts = step.physics_substep(
        tarch, convert.body_state_from_numpy(
            {f: np.asarray(getattr(jstate, f))[None] for f in BODY_FIELDS},
            device="cpu"),
        dt, PhysicsSettings(frame_rate=entry.RAGDOLL_FRAME_RATE))
    assert bool(contacts.active.any())
    for f, tol in (("pos", 5e-6), ("rot", 5e-6), ("vel", 5e-5),
                   ("omega", 5e-4)):
        np.testing.assert_allclose(getattr(got, f)[0].numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=tol, err_msg=f)


def test_ragdoll_entry_drops_on_cpu():
    """`character_ragdoll_entry` at 6 scenes: distinct drop heights, the
    ragdolls fall and stay finite above the plane after 40 frames, no
    kernel launched on the CPU."""
    before = substep_cuda.fused_substep_cuda.launches
    fn, (arch, state, fitted) = entry.character_ragdoll_entry(
        device="cpu", batch=6, seed=2, coarse=True)
    low0 = state.pos[:, :, 1].min(1).values
    assert low0.unique().numel() == 6
    state, _ = fn(state, 40)
    pos = state.pos
    assert bool(torch.isfinite(pos).all()) and bool((pos[..., 1] > -0.5).all())
    assert bool((pos.abs() < 10).all())
    assert bool((pos[:, :, 1].min(1).values < low0).all())
    assert substep_cuda.fused_substep_cuda.launches == before


@pytest.fixture(scope="module")
def host_fused(tmp_path_factory):
    """csrc/fused_substep.cu built as host C++ without FMA contraction
    (tests/torch_host_build.py, tests/test_torch_fused.py's harness)."""
    host = build_host(tmp_path_factory, "host_fused_ragdoll", FUSED_HARNESS,
                      ("host_fused_substep", "host_args_size",
                       "host_team_floats"))
    host.host_fused_substep.argtypes = [ctypes.c_void_p]
    return host


def test_host_kernel_matches_plain_on_the_landed_heap(host_fused):
    """Kernel #2's source on the landed heap: `character_ragdoll_entry`'s
    64 fitted ragdolls (the full character) dropped for 120 frames by the
    kernel built as host C++, then one step of it against the plain
    unfused step, at the physics tests' bars (pos / rot 5e-6, vel 5e-5,
    omega 5e-4).  Resting contacts and joints at their limits sit on a
    knife edge, where the card's build (its multiply-adds contracted)
    differs from plain by more (chip_smoke.py prints it); the source's
    arithmetic, rounded as plain's, does not."""
    _, (arch, state, _) = entry.character_ragdoll_entry(device="cpu",
                                                        batch=64)
    dt = 1.0 / entry.RAGDOLL_FRAME_RATE
    consts = substep_cuda.pack_consts(
        arch, PhysicsSettings(frame_rate=entry.RAGDOLL_FRAME_RATE), dt, {},
        0, "cpu")
    fields = ("pos", "rot", "vel", "omega")

    def kernel_step(st):
        st = st.replace(**{f: getattr(st, f).contiguous()
                           for f in BODY_FIELDS})
        args, keep, _ = substep_cuda.launch_args(st, None, consts, None)
        assert host_fused.host_fused_substep(ctypes.addressof(args)) == 0
        return st.replace(**{f: keep[f"{f}_out"] for f in fields})

    for _ in range(120):
        state = kernel_step(state)
    pos = state.pos
    assert bool(torch.isfinite(pos).all()) and bool((pos[..., 1] > -0.5).all())
    got = kernel_step(state)
    with torch.no_grad():
        want, contacts = step.physics_substep(
            arch, state, dt, PhysicsSettings(
                frame_rate=entry.RAGDOLL_FRAME_RATE, fused_substep="off",
                solver_backend="plain"))
    assert int(contacts.active.sum()) >= 64       # the heaps lie on the plane
    for f, tol in (("pos", 5e-6), ("rot", 5e-6), ("vel", 5e-5),
                   ("omega", 5e-4)):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   getattr(want, f).numpy(), rtol=0,
                                   atol=tol, err_msg=f)


# --------------------------------------------------------------------------
# character_entry against JAX's frame
# --------------------------------------------------------------------------

def _jax_frames(fn, tmp_path, jax_maps, keys, times):
    """JAX's two frames of the same set-up: the rigid rows and clips from
    the port's (as numpy), the character from the same FBX read by JAX's
    reader, JAX's pair-path raster frame, its outline and bone lines."""
    path = str(tmp_path / "character.fbx")
    entry.write_character(path, coarse=True)
    base = jsi.from_model_asset(jfbx.load_fbx(path))
    skinned = [base.replace(
        clip=janim.AnimationClip(
            positions=jnp.asarray(s.clip.positions.numpy()),
            rotations=jnp.asarray(s.clip.rotations.numpy()),
            scales=jnp.asarray(s.clip.scales.numpy()),
            duration=s.clip.duration, looping=s.clip.looping),
        material=jnp.asarray(s.material, jnp.int32)) for s in fn.skinned]
    r = fn.rigid
    rigid = jinst.InstancedScene(**{
        k: jnp.asarray(getattr(r, k).numpy()) for k in (
            "v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
            "material", "valid")},
        instance=jnp.asarray(r.instance.numpy().astype(np.int32)))
    rpos, rrot = (jnp.asarray(x.numpy()) for x in fn.rigid_pose)
    mats = jpt.Materials(**{k: jnp.asarray(getattr(fn.materials, k).numpy())
                            for k in ("albedo", "emissive", "roughness",
                                      "metallic")})
    sky = jpt.Sky(**{k: (jnp.asarray(v.numpy()) if isinstance(
        v, torch.Tensor) else v) for k, v in fn.sky.__dict__.items()})
    cam = jcam.look_at((8.0, 6.0, -14.0), (0.0, 3.0, 0.0),
                       v_fov=math.radians(60), aspect=W / H)
    settings = jpipe.RendererSettings(primary="raster", half_res_effects=True)
    parents = [j[1] for j in entry.CHARACTER_JOINTS]
    child = np.array([j for j, p in enumerate(parents) if p >= 0])
    parent = np.array([p for p in parents if p >= 0])

    @jax.jit
    def frame(st, k, ts):
        bvh = jsi.build_frame_bvh(rigid, rpos, rrot, skinned,
                                  [ts[i] for i in range(len(skinned))])
        scene = jpt.Scene(bvh=bvh, materials=mats, sky=sky) \
            .with_shading_table()
        ldr, st, aux = jpipe.render_frame(
            scene, cam, W, H, settings, shadow_maps=jax_maps,
            frame_state=st, prev_camera=cam, key=k)
        out = jdbg.draw_outlines(ldr, aux["gbuffer"].object_id,
                                 entry.CHARACTER0_MATERIAL)
        pose = janim.sample_clip(skinned[0].clip, ts[0])
        joints, _ = janim.forward_kinematics(skinned[0].skeleton, pose)
        segs = jnp.stack([joints[parent], joints[child]], 1)
        return jdbg.rasterize_lines(out, segs, entry.BONE_COLOR, cam), st

    st, out = jpipe.initial_frame_state(W, H), []
    for k, ts in zip(keys, times):
        img, st = frame(st, k, jnp.asarray(ts))
        out.append(np.asarray(img))
    return out


def test_character_entry_matches_jax(monkeypatch, tmp_path):
    """Two frames of `character_entry` (the group raster with last frame's
    `tile_qmin` fed back) against JAX's frames on the same arrays and
    jitter, with JAX's sun cascades given to both; the overlays change
    pixels; the skinned rows move between the frames; no kernel launched
    on the CPU."""
    from d3d12renderer_tpu_torch.render import mesh as tmesh

    monkeypatch.setattr(entry, "RASTER_SHADOW_RESOLUTION", 16)
    monkeypatch.setattr(tmesh, "atrium_scene",
                        lambda scale: [(m, i % 6) for m, i in _meshes(tmesh)])
    before = (raster.rasterize_groups.launches, image.tonemap.launches,
              image.gaussian_blur.launches)
    fn, state = entry.character_entry(device="cpu", width=W, height=H,
                                      crowd=2, seed=1, coarse=True)
    jb = jbvh.build_bvh([(m, i % 6) for m, i in _meshes(jmesh)], cache=False)
    jax_maps = jax.jit(lambda mp: jshadows.render_sun_shadow_maps(
        jb, mp, resolution=MAPS))(jshadows.fit_cascades(
            jnp.asarray(fn.camera.position.numpy()),
            -jnp.asarray(fn.sky.sun_direction.numpy())))
    maps = convert.sun_shadow_maps_from_numpy(jax_maps, "cpu")
    keys = [jax.random.PRNGKey(3), jax.random.PRNGKey(4)]
    times = [(fn.phases + i * entry.CHARACTER_FRAME_DT).numpy()
             for i in range(2)]
    want = _jax_frames(fn, tmp_path, jax_maps, keys, times)
    rows = []
    for i, k in enumerate(keys):
        jit = torch.as_tensor(np.array(jax.random.uniform(k, (2,))))
        img, state, aux = fn(state, jitter=jit, shadow_maps=maps)
        assert img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
        err = np.abs(img.numpy() - want[i]).max(-1)
        share = (err <= PIXEL_TOL).mean()
        assert share >= SHARE and err.mean() < MEAN_TOL, (i, share,
                                                          err.mean())
        assert state.tile_qmin is not None and aux["visits"]["phase1"] > 0
        assert int((img != aux["frame_ldr"]).any(-1).sum()) > 0
        rows.append(aux["bvh"].tri_v0[fn.rigid.v0.shape[0]:])
    assert i == 1 and (rows[0] - rows[1]).abs().max() > 1e-3
    assert (raster.rasterize_groups.launches, image.tonemap.launches,
            image.gaussian_blur.launches) == before
