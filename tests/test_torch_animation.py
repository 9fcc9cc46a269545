"""The port's animation (`animation/animation.py`, `skinning.py`), the
animated render split (`render/skinned_instances.py`) and the debug and
generated geometry (`render/debug_viz.py`, `geometry_gen.py`) against the
JAX package on the CPU, each JAX function under its own `jax.jit`.  The
character is entry.py's generated one (coarse), written by the port's
writer and read by each package's reader.  Tolerance 1e-5 (absolute and
relative) on poses, transforms, skinned vertices and triangle rows: XLA
fuses products into FMAs where PyTorch rounds each one.  Clip times sit
away from key times (nlerp's hemisphere flip at a dot of exactly 0)."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3d12renderer_tpu.animation import animation as janim
from d3d12renderer_tpu.animation import skinning as jskin
from d3d12renderer_tpu.assets import fbx as jfbx
from d3d12renderer_tpu.render import bvh as jbvh
from d3d12renderer_tpu.render import camera as jcam
from d3d12renderer_tpu.render import debug_viz as jdbg
from d3d12renderer_tpu.render import geometry_gen as jgeo
from d3d12renderer_tpu.render import instances as jinst
from d3d12renderer_tpu.render import mesh as jmesh
from d3d12renderer_tpu.render import skinned_instances as jsi
from d3d12renderer_tpu_torch import convert, entry
from d3d12renderer_tpu_torch.animation import animation as tanim
from d3d12renderer_tpu_torch.animation import skinning as tskin
from d3d12renderer_tpu_torch.assets import fbx as tfbx
from d3d12renderer_tpu_torch.render import bvh as tbvh
from d3d12renderer_tpu_torch.render import debug_viz as tdbg
from d3d12renderer_tpu_torch.render import geometry_gen as tgeo
from d3d12renderer_tpu_torch.render import instances as tinst
from d3d12renderer_tpu_torch.render import mesh as tmesh
from d3d12renderer_tpu_torch.render import skinned_instances as tsi
from d3d12renderer_tpu_torch.render.mesh import MeshData

from tests.test_fbx_skin_anim import CLUSTERS, CPS, JOINTS, ROT_TRACKS, TRIS

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
# Off the 30 fps key grid, inside and outside [0, duration).
TIMES = (0.013, 0.55, 1.2917, 1.98, 2.31, -0.4)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("character") / "character.fbx")
    entry.write_character(path, coarse=True)
    return jfbx.load_fbx(path), tfbx.load_fbx(path)


@pytest.fixture(scope="module")
def rigs(assets):
    ja, ta = assets
    return ((ja.skeletons[0].to_skeleton(), ja.animations[0].to_clip()),
            (ta.skeletons[0].to_skeleton("cpu"),
             ta.animations[0].to_clip("cpu")))


def test_skeleton_matches_jax(rigs):
    """Inverse bind transforms and the depth levels, in JAX's order."""
    (js, _), (ts, _) = rigs
    assert ts.level_order == tuple(tuple(int(i) for i in np.asarray(lv))
                                   for lv in js.level_order)
    np.testing.assert_array_equal(_np(ts.parent), _np(js.parent))
    np.testing.assert_array_equal(_np(ts.inv_bind_pos), _np(js.inv_bind_pos))
    np.testing.assert_array_equal(_np(ts.inv_bind_rot), _np(js.inv_bind_rot))


@pytest.mark.parametrize("looping", [True, False])
def test_sample_clip_matches_jax(rigs, looping):
    (_, jc), (_, tc) = rigs
    jc = jc.replace(looping=looping)
    tc = tc.replace(looping=looping)
    fn = jax.jit(lambda t: janim.sample_clip(jc, t))
    batched = tanim.sample_clip(tc, torch.tensor(TIMES))
    for i, t in enumerate(TIMES):
        want = fn(jnp.float32(t))
        got = tanim.sample_clip(tc, t)
        for k in ("position", "rotation", "scale"):
            np.testing.assert_allclose(_np(getattr(got, k)),
                                       _np(getattr(want, k)), **TOL)
            # One pass over times (B,) gives each time's pose exactly.
            assert torch.equal(getattr(batched, k)[i], getattr(got, k))


def test_stacked_clips_sample_each(rigs, assets):
    """`stack_clips` of two placed clips at times (2,) equals each clip
    sampled alone."""
    _, ta = assets
    clips = [entry.placed_clip(ta.animations[0], x, z, yaw).to_clip("cpu")
             for x, z, yaw in ((1.0, -2.0, 0.3), (-3.0, 0.5, 2.9))]
    both = tanim.sample_clip(tanim.stack_clips(clips),
                             torch.tensor([0.31, 1.77]))
    for i, (c, t) in enumerate(zip(clips, (0.31, 1.77))):
        one = tanim.sample_clip(c, t)
        for k in ("position", "rotation", "scale"):
            assert torch.equal(getattr(both, k)[i], getattr(one, k))


def test_pose_chain_matches_jax(rigs, assets):
    """blend_poses, forward_kinematics, skinning_transforms and
    skin_vertices on the coarse character, and extract_root_motion."""
    (js, jc), (ts, tc) = rigs
    ja, ta = assets
    mesh, skin = ta.meshes[0], ta.mesh_skin[0]

    def jchain(t0, t1):
        pose = janim.blend_poses(janim.sample_clip(jc, t0),
                                 janim.sample_clip(jc, t1), 0.3)
        wp, wr = janim.forward_kinematics(js, pose)
        sp, sr = janim.skinning_transforms(js, wp, wr)
        p, n = jskin.skin_vertices(
            jnp.asarray(mesh.positions), jnp.asarray(mesh.normals),
            jnp.asarray(skin.joint_indices), jnp.asarray(skin.joint_weights),
            sp, sr)
        return pose, wp, wr, sp, sr, p, n

    want = jax.jit(jchain)(jnp.float32(0.4), jnp.float32(1.37))
    pose = tanim.blend_poses(tanim.sample_clip(tc, 0.4),
                             tanim.sample_clip(tc, 1.37), 0.3)
    wp, wr = tanim.forward_kinematics(ts, pose)
    sp, sr = tanim.skinning_transforms(ts, wp, wr)
    p, n = tskin.skin_vertices(
        torch.as_tensor(mesh.positions), torch.as_tensor(mesh.normals),
        torch.as_tensor(skin.joint_indices).long(),
        torch.as_tensor(skin.joint_weights), sp, sr)
    got = (pose, wp, wr, sp, sr, p, n)
    for k in ("position", "rotation", "scale"):
        np.testing.assert_allclose(_np(getattr(pose, k)),
                                   _np(getattr(want[0], k)), **TOL)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)
    jclip, jground = jax.jit(janim.extract_root_motion)(jc)
    tclip, tground = tanim.extract_root_motion(tc)
    np.testing.assert_array_equal(_np(tground), _np(jground))
    np.testing.assert_array_equal(_np(tclip.positions), _np(jclip.positions))


def _rigid_ground(mm, device=None):
    ground = mm.quad(half=4.0)
    if device is None:
        rigid = jinst.build_instanced([(ground, 1)], [0])
        return rigid, jnp.zeros((1, 3)), jnp.zeros((1, 4)).at[:, 3].set(1.0)
    rigid = tinst.build_instanced([(ground, 1)], [0], device=device)
    rot = torch.zeros((1, 4))
    rot[:, 3] = 1.0
    return rigid, torch.zeros((1, 3)), rot


def test_frame_bvh_matches_jax(assets):
    """`build_frame_bvh`: a rigid ground and three characters (two
    materials, three placements) at off-key times: every row, in JAX's
    order, and the dense tables."""
    ja, ta = assets
    places = ((1.0, -2.0, 0.3), (-3.0, 0.5, 2.9), (0.5, 1.5, -1.0))
    times = (0.31, 1.77, 0.93)
    jbase = jsi.from_model_asset(ja)
    tbase = tsi.from_model_asset(ta, device="cpu")
    jinsts, tinsts = [], []
    for i, (x, z, yaw) in enumerate(places):
        placed = entry.placed_clip(ta.animations[0], x, z, yaw)
        jclip = janim.AnimationClip(
            positions=jnp.asarray(placed.positions),
            rotations=jnp.asarray(placed.rotations),
            scales=jnp.asarray(placed.scales), duration=placed.duration,
            looping=placed.looping)
        jinsts.append(jbase.replace(clip=jclip,
                                    material=jnp.asarray(2 + (i == 0))))
        tinsts.append(tsi.with_clip(tbase, placed.to_clip("cpu"),
                                    2 + (i == 0)))
    rigid, pos, rot = _rigid_ground(jmesh)
    want = jax.jit(lambda ts: jsi.build_frame_bvh(
        rigid, pos, rot, jinsts, [ts[0], ts[1], ts[2]]))(jnp.asarray(times))
    trigid, tpos, trot = _rigid_ground(tmesh, "cpu")
    got = tsi.build_frame_bvh(trigid, tpos, trot, tinsts, torch.tensor(times))
    for k in ("tri_v0", "tri_e1", "tri_e2", "tri_n0", "tri_n1", "tri_n2",
              "tri_uv0", "tri_uv1", "tri_uv2", "tri_material", "tri_valid"):
        np.testing.assert_allclose(_np(getattr(got, k)),
                                   _np(getattr(want, k)), **TOL)
    # The dense rows divide by the triangle's squared area: 1e-5 in a
    # vertex moves a small triangle's rows by up to ~1e-3 of their size.
    for k in ("n", "e1p", "e2p"):
        a, b = _np(getattr(got.dense, k)), _np(getattr(want.dense, k))
        scale = np.abs(b).max(-1, keepdims=True) + 1e-6
        assert np.all(np.abs(a - b) <= 2e-3 * scale), k
    np.testing.assert_array_equal(_np(got.dense.valid), _np(want.dense.valid))
    # The skinned rows moved away from the bind pose.
    bind = tsi.build_frame_bvh(None, None, None, tinsts[:1], [0.0])
    moved = tsi.build_frame_bvh(None, None, None, tinsts[:1], [0.5])
    assert (bind.tri_v0 - moved.tri_v0).abs().max() > 0.05


def test_frame_bvh_traces_animated_geometry(tmp_path):
    """tests/test_animated_split.py's folding arm and probe rays: the
    port's one-leaf shell hits what JAX's does, at t = 0 and t = 1, and its
    closest hits equal those of a BVH built from the posed triangles."""
    path = str(tmp_path / "arm.fbx")
    tfbx.write_fbx_skinned(path, CPS, TRIS, JOINTS, CLUSTERS, ROT_TRACKS)
    ja, ta = jfbx.load_fbx(path), tfbx.load_fbx(path)
    ja.animations[0].looping = ta.animations[0].looping = False
    jinst_, tinst_ = jsi.from_model_asset(ja), tsi.from_model_asset(
        ta, device="cpu")
    o = np.array([[0.35, 1.5, -3.0], [-0.5, 1.2, -3.0]], np.float32)
    d = np.ascontiguousarray(np.broadcast_to(
        np.array([0.0, 0.0, 1.0], np.float32), o.shape))
    for t, expect in ((0.0, [True, False]), (1.0, [False, True])):
        jb = jsi.build_frame_bvh(None, None, None, [jinst_], [jnp.float32(t)])
        want = jbvh.closest_hit(jb, jnp.asarray(o), jnp.asarray(d))
        tb = tsi.build_frame_bvh(None, None, None, [tinst_], [t])
        got = tbvh.closest_hit(tb, torch.as_tensor(o), torch.as_tensor(d))
        assert got["hit"].tolist() == expect == np.asarray(
            want["hit"]).tolist()
        np.testing.assert_allclose(_np(got["t"])[expect],
                                   np.asarray(want["t"])[expect], **TOL)
        v0 = _np(tb.tri_v0)
        posed = MeshData(np.concatenate([v0, v0 + _np(tb.tri_e1),
                                         v0 + _np(tb.tri_e2)]),
                         np.zeros((3 * len(v0), 3), np.float32),
                         np.zeros((3 * len(v0), 2), np.float32),
                         np.arange(3 * len(v0)).reshape(3, -1).T.astype(
                             np.int32))
        built = tbvh.build_bvh([(posed, 0)], device="cpu")
        ref = tbvh.closest_hit(built, torch.as_tensor(o), torch.as_tensor(d))
        assert torch.equal(ref["hit"], got["hit"])
        assert torch.equal(ref["t"], got["t"])


def test_wire_primitives_match_jax():
    for a, b in ((tdbg.wire_box((1, 2, 3), (0.5, 1, 2), (0.1, 0.2, 0.3,
                                                            0.927)),
                  jdbg.wire_box((1, 2, 3), (0.5, 1, 2), (0.1, 0.2, 0.3,
                                                         0.927))),
                 (tdbg.wire_sphere((0, 1, 0), 2.0, 12),
                  jdbg.wire_sphere((0, 1, 0), 2.0, 12)),
                 (tdbg.wire_cone((0, 0, 0), (0, -1, 0.2), 0.5, 2.0),
                  jdbg.wire_cone((0, 0, 0), (0, -1, 0.2), 0.5, 2.0))):
        np.testing.assert_array_equal(a, b)


def test_lines_and_outlines_match_jax():
    """`rasterize_lines` (segments crossing the image edges and the near
    plane), `object_outlines` (thickness 1 and 2) and `draw_outlines`
    (an object on the image border: the wrap-around roll), equal to
    JAX's."""
    jc = jcam.look_at((0, 0, 5), (0, 0, 0), aspect=1.5)
    tc = convert.camera_from_numpy(jc, "cpu")
    rng = np.random.default_rng(3)
    img = rng.random((48, 72, 3)).astype(np.float32)
    segs = np.concatenate([jdbg.wire_box((0, 0, 0), (1, 1, 1)),
                           jdbg.wire_sphere((1.5, 0.5, 0), 2.5, 8),
                           [[[0, 0, 0], [0, 0, 9.0]]]]).astype(np.float32)
    want = jax.jit(lambda i, s: jdbg.rasterize_lines(i, s, (1.0, 0.2, 0.0),
                                                     jc))(img, segs)
    got = tdbg.rasterize_lines(torch.as_tensor(img), torch.as_tensor(segs),
                               (1.0, 0.2, 0.0), tc)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert (np.abs(_np(got) - img).max(-1) > 0).sum() > 100
    ids = np.zeros((16, 20), np.int32)
    ids[4:10, 4:10] = 7
    ids[0:3, 15:20] = 3
    for th in (1, 2):
        np.testing.assert_array_equal(
            _np(tdbg.object_outlines(torch.as_tensor(ids), th)),
            np.asarray(jax.jit(lambda i: jdbg.object_outlines(i, th))(ids)))
    base = rng.random((16, 20, 3)).astype(np.float32)
    for sel in (7, 3):
        np.testing.assert_array_equal(
            _np(tdbg.draw_outlines(torch.as_tensor(base),
                                   torch.as_tensor(ids), sel)),
            np.asarray(jax.jit(lambda b, i: jdbg.draw_outlines(b, i, sel))(
                base, ids)))


def test_generated_geometry_matches_jax():
    """The meta-ball field and surface nets at resolution 16 (field and
    vertices 1e-5, masks and quads equal), `metaballs_mesh` at 24, the Koch
    outline and mesh."""
    centers = np.array([[0.0, 0.0, 0.0], [0.7, 0.3, 0.1],
                        [-0.4, 0.5, -0.3]], np.float32)
    radii = np.array([0.6, 0.45, 0.4], np.float32)
    jf, jp = jax.jit(lambda c, r: jgeo.metaball_field(c, r, 16))(centers,
                                                                 radii)
    tf, tp = tgeo.metaball_field(torch.as_tensor(centers),
                                 torch.as_tensor(radii), 16)
    np.testing.assert_allclose(_np(tf), np.asarray(jf), **TOL)
    np.testing.assert_allclose(_np(tp), np.asarray(jp), **TOL)
    want = jax.jit(jgeo.surface_nets)(jf, jp)
    got = tgeo.surface_nets(torch.as_tensor(np.asarray(jf)),
                            torch.as_tensor(np.asarray(jp)))
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), **TOL)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    tm = tgeo.metaballs_mesh(centers, radii, 24, device="cpu")
    jm = jgeo.metaballs_mesh(centers, radii, 24)
    np.testing.assert_array_equal(tm.indices, jm.indices)
    np.testing.assert_allclose(tm.positions, jm.positions, **TOL)
    np.testing.assert_allclose(tm.normals, jm.normals, atol=1e-4)
    np.testing.assert_array_equal(tgeo.koch_snowflake(3),
                                  jgeo.koch_snowflake(3))
    a, b = tgeo.koch_fractal_3d(2), jgeo.koch_fractal_3d(2)
    for k in ("positions", "normals", "uvs", "indices"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
