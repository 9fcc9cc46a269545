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


# --------------------------------------------------------------------------
# The game frame: the per-frame tree, the per-frame fn, the pile's seed
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_walk(tmp_path_factory):
    """csrc/ray_trace.cu's BVH walk built as host C++."""
    import ctypes

    from tests.test_torch_ray import _HARNESS
    from tests.torch_host_build import build_host

    host = build_host(tmp_path_factory, "host_ray_tree", _HARNESS,
                      ("host_ray_bvh",))
    host.host_ray_bvh.argtypes = [ctypes.c_void_p]
    return host.host_ray_bvh


def _tree_rays(world, seed):
    """The flythrough's sun cascades at 24^2 from its first camera (the
    frame's shadow rays), and rays from that camera through the pile."""
    from d3d12renderer_tpu_torch.render.shadows import fit_cascades

    cam = entry.flythrough_camera(0, 600, W, H, device="cpu")
    maps = fit_cascades(cam.position, -world.sky.sun_direction)
    u = (torch.arange(24) + 0.5) / 24 * 2 - 1
    gu, gv = torch.meshgrid(u, u, indexing="xy")
    ext = maps.extent[:, None, None, None]
    o = (maps.origin[:, None, None] + maps.right[:, None, None] * gu[..., None]
         * ext + maps.up[:, None, None] * gv[..., None] * ext).reshape(-1, 3)
    d = maps.direction.expand(o.shape)
    g = torch.Generator().manual_seed(seed)
    target = torch.rand(1024, 3, generator=g) * torch.tensor([3.4, 2.0, 3.4]) \
        - torch.tensor([1.7, 0.0, 1.7])
    d2 = target - cam.position
    d2 = d2 / d2.norm(dim=-1, keepdim=True)
    o = torch.cat([o, cam.position.expand(1024, 3)]).contiguous()
    d = torch.cat([d, d2]).contiguous()
    return o, d, torch.full((o.shape[0],), 1e30)


@pytest.mark.parametrize("when", ["initial", "settled"])
def test_instance_tree_hits_equal_the_one_leaf(pile, host_walk, when):
    """The per-frame tree (`retransform(tree=True)`) walked by kernel #3's
    source (host C++) gives the one leaf's hits on the pile as built and
    after the settling frames: t and hit bit for bit, and tri everywhere
    (the rows keep their order, and the walk keeps the lowest row on a tie
    in t); the tree tests a few rows a ray where the leaf tests 2,560."""
    from d3d12renderer_tpu_torch.ops import ray_trace

    _, jstate, settled, _, world, _ = pile
    pos, rot = _poses(jstate if when == "initial" else settled, False)
    pos, rot = torch.as_tensor(pos), torch.as_tensor(rot)
    leaf = retransform(world.instances, pos, rot)
    tree = retransform(world.instances, pos, rot, tree=True)
    for f in ("tri_v0", "tri_e1", "tri_e2", "tri_n0", "tri_material"):
        assert torch.equal(getattr(leaf, f), getattr(tree, f)), f
    o, d, tm = _tree_rays(world, 3 if when == "initial" else 4)
    out = {}
    for name, bvh in (("leaf", leaf), ("tree", tree)):
        planes, nodes = ray_trace.kernel_tables(bvh)
        stats = torch.zeros(2, dtype=torch.int64)
        t, tri = ray_trace.launch(host_walk, planes, nodes, o, d, tm, False,
                                  stats=stats)
        out[name] = (t, tri, stats.tolist())
    assert torch.equal(out["tree"][0], out["leaf"][0])
    assert torch.equal(out["tree"][1] >= 0, out["leaf"][1] >= 0)
    assert torch.equal(out["tree"][1], out["leaf"][1])
    hits = int((out["leaf"][1] >= 0).sum())
    assert hits > 0.5 * o.shape[0]
    rows = world.instances.valid.shape[0]
    assert out["leaf"][2][0] % rows == 0 and out["leaf"][2][0] >= hits * rows
    assert out["tree"][2][0] < 0.02 * out["leaf"][2][0], out["tree"][2]


def test_instance_tree_covers_every_row_once(pile):
    """`instance_tree`: leaves of at most LEAF_ROWS rows, each within one
    instance, every valid row in one leaf, pre-order skip links, and the
    refitted boxes holding their rows' corners."""
    from d3d12renderer_tpu_torch.render import instances

    world = pile[4]
    scene = world.instances
    tree = instances.instance_tree(scene)
    first = tree.node_first.tolist()
    count = tree.node_count.tolist()
    miss = tree.node_miss.tolist()
    n = len(first)
    leaves = [(a, c) for a, c in zip(first, count) if c > 0]
    covered = sorted(r for a, c in leaves for r in range(a, a + c))
    assert covered == list(range(int(scene.valid.sum())))
    assert all(c <= instances.LEAF_ROWS for _, c in leaves)
    inst = scene.instance.tolist()
    assert all(inst[a] == inst[a + c - 1] for a, c in leaves)
    assert miss[0] == n and all(i < miss[i] <= n for i in range(n))
    for i in range(n):                   # an inner node's children
        if count[i] == 0:
            assert miss[i + 1] < miss[i] and miss[miss[i + 1]] == miss[i]
    pos, rot = (torch.as_tensor(x) for x in _poses(pile[2], False))
    bvh = retransform(scene, pos, rot, tree=True)
    v = [bvh.tri_v0, bvh.tri_v0 + bvh.tri_e1, bvh.tri_v0 + bvh.tri_e2]
    leaf_nodes = [i for i in range(n) if count[i] > 0]
    for i in range(n):
        rows = [r for j in leaf_nodes if i <= j < miss[i]
                for r in range(first[j], first[j] + count[j])]
        pts = torch.cat([x[rows] for x in v])
        assert bool((pts >= bvh.node_min[i] - 1e-5).all()), i
        assert bool((pts <= bvh.node_max[i] + 1e-5).all()), i


def _todays_loop(world, settled, jitters):
    """The filmed frames as the flythrough made them before its per-frame
    `fn`: a physics step, the one-leaf retransform, the cascades and the
    frame of `render_frame_with_shadows`."""
    from d3d12renderer_tpu_torch.render import pathtracer as pt
    from d3d12renderer_tpu_torch.render.pipeline import (
        RendererSettings, initial_frame_state, render_frame_with_shadows)

    state, fstate, prev, out = settled, initial_frame_state(W, H, "cpu"), \
        None, []
    static_pos = torch.zeros((1, 3))
    static_rot = torch.tensor([[0.0, 0.0, 0.0, 1.0]])
    with torch.inference_mode():
        for f in range(FRAMES):
            state = step.physics_step(world.arch, state, PhysicsSettings(),
                                      entry.FLYTHROUGH_FRAME_DT,
                                      entry.FLYTHROUGH_SUBSTEPS)[0]
            bvh = retransform(world.instances,
                              torch.cat([state.pos[0], static_pos]),
                              torch.cat([state.rot[0], static_rot]))
            cam = entry.flythrough_camera(f, FRAMES, W, H, device="cpu")
            ldr, fstate, _ = render_frame_with_shadows(
                pt.Scene(bvh=bvh, materials=world.materials, sky=world.sky),
                cam, W, H, RendererSettings(primary="raster"),
                shadow_resolution=SHADOW_RES, point_lights=world.lights,
                frame_state=fstate, prev_camera=prev or cam,
                jitter=jitters[f])
            prev = cam
            out.append(ldr)
    return out, state


def test_game_fn_equals_the_loop_it_replaces(pile):
    """`flythrough_entry`'s per-frame `fn` (the physics runner, the posed
    tree, the cascades, `render_frame` with its graph cache) gives the
    frames and bodies of the loop it replaces, bit for bit on the CPU, at
    64x64 with 32^2 cascades from the settled pile; its spans and counters
    with `profile_stages`."""
    settled, world = pile[2], pile[4]
    jitters = [torch.rand(2, generator=torch.Generator().manual_seed(f))
               for f in range(FRAMES + 1)]
    want, want_state = _todays_loop(world, _port(settled), jitters)
    got = entry.flythrough_entry(device="cpu", width=W, height=H,
                                 frames=FRAMES, settle_frames=0,
                                 state=_port(settled), jitters=jitters,
                                 shadow_resolution=SHADOW_RES)
    for a, b in zip(got["frames"], want):
        assert torch.equal(a, b)
    for f in BODY_FIELDS:
        assert torch.equal(getattr(got["state"], f), getattr(want_state, f))
    game = got["game"]
    assert game.frame == FRAMES and game.prev_camera is not None
    ldr, nxt, aux = got["fn"](game, jitter=jitters[FRAMES],
                              profile_stages=True)
    assert nxt.frame == FRAMES + 1 and ldr.shape == (H, W, 3)
    for name in ("game.frame", "phys.frame", "inst.tree", "shadow.cascades",
                 "raster.frame", "raster.gbuffer", "raster.post"):
        assert aux["stage_ms"][name] >= 0.0, name
    counts = aux["counts"]
    assert counts["shadow.rays"] == 3 * SHADOW_RES ** 2
    assert counts["phys.pairs"] == 18 + 153
    assert counts["phys.contact_rows"] > 0
    assert aux["bvh"].node_first.shape[0] > 1


def test_pile_seed_draws_the_bodies():
    """`add_flythrough_pile(seed=)`: the default is examples/flythrough.py's
    seed 4 (the pile unchanged); another seed moves the bodies' x and z
    only."""
    def pile_of(*args):
        b = JaxSceneBuilder()
        kinds = scenes.add_flythrough_pile(b, *args)
        return kinds, np.array([body.pos for body in b.bodies])

    kinds, default = pile_of()
    kinds4, four = pile_of(4)
    kinds9, nine = pile_of(9)
    assert kinds == kinds4 == kinds9
    np.testing.assert_array_equal(default, four)
    np.testing.assert_array_equal(default[:, 1], nine[:, 1])
    assert not np.allclose(default[:, [0, 2]], nine[:, [0, 2]])
    world = entry.flythrough_world("cpu", pile_seed=9)
    np.testing.assert_allclose(world.state.pos[0, :, 1].numpy(),
                               nine[:, 1], atol=1e-6)
