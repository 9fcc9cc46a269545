"""The schedule of the team solve (csrc/solver_rows.cuh) on the CPU: the
colors of every table touch disjoint dynamic bodies, which lets the lanes of
a team solve a color's rows at the same time; the team's lane -> row map
takes every row of every color once; the team width a launch takes; and
csrc/colored_solver.cu, compiled as host C++ (tests/torch_host_build.py),
against the plain solve.  The archetypes: the plane-only ragdoll, the
jointed chain, the self-colliding ragdoll (plane and collider-pair rows in
one contact table, pair rows with a dynamic A), the slider zoo (every
joint kind and all six pair functions), examples/showcase.py's terrain
drop (terrain rows, then pair rows) and the ridge (triangle-exact terrain
rows).
"""

import ctypes
import functools
import types

import pytest
import torch
from hypothesis import HealthCheck, example, given, settings
from hypothesis import strategies as st

from d3d12renderer_tpu_torch.convert import body_state_from_numpy
from d3d12renderer_tpu_torch.learning.loco_env import ACTION_SIZE, LocoEnv
from d3d12renderer_tpu_torch.models import scenes as zoo_scenes
from d3d12renderer_tpu_torch.physics import solver_cuda, step
from d3d12renderer_tpu_torch.physics.builder import SceneBuilder
from d3d12renderer_tpu_torch.physics.types import PhysicsSettings

from tests.test_torch_collision import _posed_inputs, _zoo_inputs
from tests.test_torch_fused import _build_chain, _chain_state
from tests.torch_host_build import build_host

torch.set_num_threads(1)

DT = 1.0 / 60.0
WIDTHS = (1,) + solver_cuda.TEAM_WIDTHS


def _solver(arch, iterations=4, backend="plain"):
    return solver_cuda.ColoredSolver(arch, arch.num_contact_rows, iterations,
                                     backend)


def color_conflicts(solver):
    """(table kind, color, body) for every dynamic body that two rows of one
    color would write.  A side that is static for the whole table is never
    written; neither is a body that is not dynamic (the world slot)."""
    out = []
    for m in solver.tables:
        for c, (lo, hi) in enumerate(m.color_bounds):
            seen = set()
            for r in range(lo, hi):
                written = {int(body) for body, static in (
                    (m.body_a[r], m.a_static), (m.body_b[r], m.b_static))
                    if not static and solver.dynamic[body]}
                out += [(m.kind, c, body) for body in written & seen]
                seen |= written
    return out


WHICH = ("ragdoll", "chain", "self_collision", "zoo", "terrain_drop",
         "ridge")
PLAIN = PhysicsSettings(frame_rate=60, fused_substep="off",
                        solver_backend="plain")


@pytest.fixture(scope="module")
def ragdoll():
    return LocoEnv(device="cpu")


@pytest.fixture(scope="module")
def chain():
    return _build_chain(SceneBuilder)


@functools.lru_cache(maxsize=None)
def _self_colliding():
    return LocoEnv(self_collision=True, device="cpu")


@functools.lru_cache(maxsize=None)
def _zoo():
    b = SceneBuilder()
    info = zoo_scenes.add_slider_zoo(b)
    arch, state0 = b.finalize(device="cpu")
    return arch, state0, info


@functools.lru_cache(maxsize=None)
def _terrain(which):
    b = SceneBuilder()
    if which == "terrain_drop":
        zoo_scenes.add_terrain_drop(b, zoo_scenes.terrain_drop_heights())
        return b.finalize(device="cpu")
    zoo_scenes.add_ridge(b)
    return b.finalize(device="cpu", terrain_collision="triangles")


def _arch(which, ragdoll, chain):
    return {"ragdoll": lambda: ragdoll.arch, "chain": lambda: chain[0],
            "self_collision": lambda: _self_colliding().arch,
            "zoo": lambda: _zoo()[0],
            "terrain_drop": lambda: _terrain("terrain_drop")[0],
            "ridge": lambda: _terrain("ridge")[0]}[which]()


# --------------------------------------------------------------------------
# Colors touch disjoint dynamic bodies
# --------------------------------------------------------------------------

@pytest.mark.parametrize("which", WHICH)
def test_colors_write_disjoint_dynamic_bodies(ragdoll, chain, which):
    solver = _solver(_arch(which, ragdoll, chain))
    assert color_conflicts(solver) == []
    if which == "ragdoll":
        # 6 hinge rows in one color, 7 cone-twist rows in 5, 17 plane rows
        # in 4 (the torso has four colliders).
        assert [[hi - lo for lo, hi in m.color_bounds]
                for m in solver.tables] == [[6], [3, 1, 1, 1, 1],
                                            [14, 1, 1, 1]]
    if which in ("self_collision", "zoo", "terrain_drop"):
        # Pair rows write both of their bodies.
        contact = solver.tables[-1]
        assert not contact.a_static and not contact.b_static
    if which in ("terrain_drop", "ridge"):
        # Terrain rows, A the world slot, sit between the plane rows (none
        # here) and the buckets.
        arch = _arch(which, ragdoll, chain)
        ia, _ = solver_cuda.contact_bodies(arch)
        q2 = arch.vs_terrain_collider.shape[0]
        assert q2 and (ia[:q2] == arch.world_body).all()


def test_color_conflicts_finds_a_shared_body(ragdoll):
    """The check itself: merging the torso's four plane rows into one color
    makes the torso a body that two rows of one color write."""
    solver = _solver(ragdoll.arch)
    contact = solver.tables[-1]
    contact.color_bounds = [(0, contact.perm.shape[0])]
    torso = int(ragdoll.part_idx[0])
    assert {(k, b) for k, _, b in color_conflicts(solver)} == {
        ("contact", torso)}


def test_color_conflicts_finds_a_pair_row_on_body_a():
    """The check sees body A of a pair row: merging the self-colliding
    ragdoll's first two contact colors puts two rows that write one body
    into one color."""
    solver = _solver(_self_colliding().arch)
    contact = solver.tables[-1]
    (lo, _), (_, hi) = contact.color_bounds[:2]
    contact.color_bounds = [(lo, hi)] + contact.color_bounds[2:]
    assert color_conflicts(solver)


_KINDS = ("hinge", "cone_twist", "distance", "ball", "fixed", "slider")


@st.composite
def scenes(draw):
    """A random scene of 2-6 bodies (some kinematic) on a ground plane, each
    with up to three colliders, and up to 8 joints of the six kinds between
    random pairs of bodies and the world (-1).  Each body joins a shared
    no-collide group or not, so collider pairs come and go."""
    n = draw(st.integers(2, 6))
    b = SceneBuilder()
    b.add_static_plane((0.0, 1.0, 0.0), 0.0)
    group = b.new_no_collide_group()
    for i in range(n):
        body = b.add_body((0.7 * i, 0.6, 0.1 * i),
                          kinematic=draw(st.booleans()) and i > 0)
        if draw(st.booleans()):
            b.set_no_collide_group(body, group)
        for shape in draw(st.lists(st.sampled_from(["sphere", "box",
                                                    "capsule"]),
                                   max_size=3)):
            if shape == "sphere":
                b.add_sphere_collider(body, 0.3)
            elif shape == "box":
                b.add_box_collider(body, (0.2, 0.3, 0.2))
            else:
                b.add_capsule_collider(body, 0.15, 0.2)
    pairs = draw(st.lists(st.tuples(st.sampled_from(_KINDS),
                                    st.integers(-1, n - 1),
                                    st.integers(-1, n - 1)), max_size=8))
    for kind, a, c in pairs:
        if a == c:
            continue
        anchor = (0.35 * (max(a, 0) + max(c, 0)), 0.6, 0.0)
        if kind == "hinge":
            b.add_hinge_joint(a, c, anchor, (0.0, 0.0, 1.0), min_limit=-0.5,
                              max_limit=0.5)
        elif kind == "cone_twist":
            b.add_cone_twist_joint(a, c, anchor, (1.0, 0.0, 0.0),
                                   swing_limit=0.7, twist_limit=0.3)
        elif kind == "distance":
            b.add_distance_joint(a, c, anchor, (anchor[0], 0.9, 0.0))
        elif kind == "ball":
            b.add_ball_joint(a, c, anchor)
        elif kind == "slider":
            b.add_slider_joint(a, c, anchor, (1.0, 0.0, 0.0), neg_limit=-0.2,
                               pos_limit=0.2)
        else:
            b.add_fixed_joint(a, c, anchor)
    return b.finalize(device="cpu")[0]


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(scene=st.one_of(scenes(), st.sampled_from(["self_collision", "zoo"])))
@example(scene="self_collision")
@example(scene="zoo")
def test_builder_colors_write_disjoint_dynamic_bodies(scene):
    """Random scenes, and the self-colliding ragdoll and the zoo by name."""
    arch = _arch(scene, None, None) if isinstance(scene, str) else scene
    assert color_conflicts(_solver(arch)) == []


# --------------------------------------------------------------------------
# The kernel sources as host C++
# --------------------------------------------------------------------------

_HARNESS = """\
#include "colored_solver.cu"

// The kernel body once per scene index: a team of one lane per scene, one
// team per block, its scene in the harness's shared buffer.
extern "C" int host_colored_solve(
    const float* vel_in, const float* omega_in, float* vel_out,
    float* omega_out, const float* prep, int prep_stride, const int* tables,
    int num_tables, const int* colors, const int* body_a, const int* body_b,
    const int* dynamic, int num_slots, int num_impulses, int batch,
    int iterations) {
  host_dynamic_shared.assign(
      colored_team_floats(num_slots, prep_stride, num_impulses, 1), 0.0f);
  blockDim = dim3(1);
  for (int s = 0; s < batch; ++s) {
    blockIdx = dim3(s);
    threadIdx = dim3(0);
    colored_solver_kernel<1>(vel_in, omega_in, vel_out, omega_out, prep,
                             prep_stride, tables, num_tables, colors, body_a,
                             body_b, dynamic, num_slots, num_impulses, batch,
                             iterations);
  }
  return 0;
}

// How often the lanes of a team of width W take each packed row in one
// iteration of the team solve (`team_rows`), into visits[row]; -1 if a lane
// takes a row outside its color.
template <int W>
int visits(const int* tables, int num_tables, const int* colors, int* out) {
  int bad = 0;
  for (int t = 0; t < num_tables; ++t) {
    const int* T = tables + t * TABLE_INTS;
    const int* bounds = colors + 2 * T[T_COLOR_BASE];
    for (int c = 0; c < T[T_NUM_COLORS]; ++c) {
      const int lo = bounds[2 * c], hi = bounds[2 * c + 1];
      for (int lane = 0; lane < W; ++lane)
        team_rows<W>(lane, lo, hi, [&](int r) {
          bad |= r < lo || r >= hi;
          out[T[T_ROW_BASE] + r] += 1;
        });
    }
  }
  return bad ? -1 : 0;
}

extern "C" int host_team_floats(int num_slots, int prep_stride,
                                int num_impulses, int width) {
  return colored_team_floats(num_slots, prep_stride, num_impulses, width);
}

extern "C" int host_team_visits(int width, const int* tables, int num_tables,
                                const int* colors, int* out) {
  switch (width) {
    case 1: return visits<1>(tables, num_tables, colors, out);
    case 8: return visits<8>(tables, num_tables, colors, out);
    case 16: return visits<16>(tables, num_tables, colors, out);
    case 32: return visits<32>(tables, num_tables, colors, out);
    default: return -2;
  }
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """csrc/colored_solver.cu built as host C++."""
    lib = build_host(tmp_path_factory, "host_colored", _HARNESS,
                     ("host_colored_solve", "host_team_visits",
                      "host_team_floats"))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.host_colored_solve.argtypes = [ptr] * 5 + [i32, ptr, i32] + [ptr] * 4 \
        + [i32] * 4
    lib.host_team_visits.argtypes = [i32, ptr, i32, ptr, ptr]
    return lib


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("which", WHICH)
def test_team_takes_every_row_once(host, ragdoll, chain, which, width):
    """For W in 1, 8, 16 and 32, the lanes of a team take every row of every
    color exactly once per iteration, and only rows of that color."""
    solver = _solver(_arch(which, ragdoll, chain))
    arrays = solver.kernel_arrays(torch.device("cpu"))
    rows = arrays.body_a.shape[0]
    out = torch.zeros(rows, dtype=torch.int32)
    assert host.host_team_visits(width, arrays.tables.data_ptr(),
                                 len(solver.tables), arrays.colors.data_ptr(),
                                 out.data_ptr()) == 0
    assert out.tolist() == [1] * rows


@pytest.mark.parametrize("width", WIDTHS)
def test_team_floats_match_the_kernel(host, width):
    for slots, stride, imps in ((15, 2096, 176), (65, 9004, 777)):
        assert host.host_team_floats(slots, stride, imps, width) \
            == solver_cuda.colored_team_floats(slots, stride, imps, width)


def _ragdoll_prep(env):
    """Preps of 3 disturbed ragdolls lowered onto the ground (as
    tests/test_torch_port.py's), with their motor overrides."""
    gen = torch.Generator().manual_seed(0)
    _, st_ = env.reset(3, gen)
    b = st_.bodies
    b = b.replace(pos=b.pos - torch.tensor([0.0, 0.125, 0.0]),
                  vel=torch.rand(b.vel.shape, generator=gen) - 0.5,
                  omega=torch.rand(b.omega.shape, generator=gen) - 0.5)
    act = torch.rand((3, ACTION_SIZE), generator=gen) * 2.0 - 1.0
    with torch.no_grad():
        return step.substep_prep(env.arch, b, DT, env.settings,
                                 env._motor_overrides(act))


def _chain_prep(chain):
    arch, state0 = chain
    state = body_state_from_numpy(_chain_state(state0), device="cpu")
    with torch.no_grad():
        return step.substep_prep(arch, state, DT, PLAIN)


def _self_colliding_prep():
    """Preps of the self-colliding ragdolls posed into contact
    (tests/test_torch_collision.py), with their motor overrides."""
    env = _self_colliding()
    state0 = types.SimpleNamespace(**{f: getattr(env._state0, f)[0].numpy()
                                      for f in ("pos", "rot", "vel", "omega",
                                                "force", "torque")})
    state_np, action = _posed_inputs(state0, env.part_idx.numpy())
    state = body_state_from_numpy(state_np, device="cpu")
    with torch.no_grad():
        return step.substep_prep(env.arch, state, DT, env.settings,
                                 env._motor_overrides(torch.as_tensor(action)))


def _zoo_prep():
    """Preps of 3 zoo scenes, the carriage past its limits."""
    arch, state0, info = _zoo()
    state = body_state_from_numpy(_zoo_inputs(state0, info, batch=3),
                                  device="cpu")
    with torch.no_grad():
        return step.substep_prep(arch, state, DT, PLAIN)


def _terrain_prep(which):
    """Preps of 3 scenes of the terrain drop (bodies 0.3 m above the
    surface, moving: terrain and pair rows touch) or the ridge (the box
    5 cm into the crest)."""
    from d3d12renderer_tpu_torch.terrain.heightmap import (
        sample_height_bilinear)

    arch, state0 = _terrain(which)
    gen = torch.Generator().manual_seed(1)
    pos = state0.pos.expand(3, -1, -1).clone()
    if which == "ridge":
        pos[..., 1] = 2.05
    else:
        y, _ = sample_height_bilinear(arch.terrain_height[0],
                                      arch.terrain_origin[0],
                                      arch.terrain_cell[0], pos[..., 0],
                                      pos[..., 2])
        pos[..., 1] = y + 0.3
        pos[:, 1] = pos[:, 0] + torch.tensor([0.5, 0.2, 0.3])
    state = state0.replace(
        pos=pos, rot=state0.rot.expand(3, -1, -1).contiguous(),
        vel=torch.rand(pos.shape, generator=gen) - 0.5,
        omega=torch.rand(pos.shape, generator=gen) - 0.5,
        force=torch.zeros_like(pos), torque=torch.zeros_like(pos))
    with torch.no_grad():
        return step.substep_prep(arch, state, DT, PLAIN)


@pytest.mark.parametrize("which", WHICH)
def test_host_colored_kernel_matches_plain(host, ragdoll, chain, which):
    """30 iterations through the kernel source, on the wrapper's packed
    buffer, against the plain solve: equal bit for bit.  g++
    -ffp-contract=off rounds every operation as PyTorch's CPU ops do, and
    the row solves take the plain version's operation order.  The
    self-colliding, zoo and terrain-drop scenes have active pair rows, the
    terrain scenes active terrain rows."""
    arch = _arch(which, ragdoll, chain)
    sp = {"ragdoll": lambda: _ragdoll_prep(ragdoll),
          "chain": lambda: _chain_prep(chain),
          "self_collision": _self_colliding_prep,
          "zoo": _zoo_prep,
          "terrain_drop": lambda: _terrain_prep("terrain_drop"),
          "ridge": lambda: _terrain_prep("ridge")}[which]()
    q = arch.vs_plane_collider.shape[0]
    q2 = arch.vs_terrain_collider.shape[0]
    if which in ("self_collision", "zoo", "terrain_drop"):
        assert sp.contacts.active[:, q + q2:].any()
    if which in ("terrain_drop", "ridge"):
        assert sp.contacts.active[:, q:q + q2].any()
    solver = _solver(arch, iterations=30)
    batch, slots = sp.vel1.shape[0], sp.vel1.shape[1]
    args = (sp.joint_preps, sp.contact_prep, sp.vel1, sp.omega1)
    want_v, want_w = solver.plain(*args)
    prep = solver.pack_prep(sp.joint_preps, sp.contact_prep, batch,
                            torch.device("cpu"))
    arrays = solver.kernel_arrays(torch.device("cpu"))
    vel, omega = sp.vel1.contiguous(), sp.omega1.contiguous()
    got_v, got_w = torch.empty_like(vel), torch.empty_like(omega)
    assert host.host_colored_solve(
        vel.data_ptr(), omega.data_ptr(), got_v.data_ptr(), got_w.data_ptr(),
        prep.data_ptr(), prep.shape[1], arrays.tables.data_ptr(),
        len(solver.tables), arrays.colors.data_ptr(),
        arrays.body_a.data_ptr(), arrays.body_b.data_ptr(),
        arrays.dynamic.data_ptr(), slots, solver.num_impulses, batch,
        30) == 0
    assert not torch.equal(got_v, vel)
    assert torch.equal(got_v, want_v) and torch.equal(got_w, want_w)


def test_team_width_rule(ragdoll):
    """A launch takes the narrowest width from TEAM_WIDTH up whose block of
    WARP // width teams fits: 8 for the plane-only ragdoll (38,528 B), 16
    for the self-colliding one (59,040 B a team, four teams 236,160 B over
    the 232,448 B limit); it raises where one team of 32 lanes does not
    fit.  Never the plain solve."""
    limit = solver_cuda.SHARED_LIMIT

    def floats_of(arch):
        solver = _solver(arch)
        return lambda width: solver_cuda.colored_team_floats(
            arch.num_bodies + 1, solver.prep_stride, solver.num_impulses,
            width)

    plain = floats_of(ragdoll.arch)
    colliding = floats_of(_self_colliding().arch)
    assert solver_cuda.block_shared_bytes(plain(8), 8) == 38528
    assert colliding(8) * 4 == 59040
    assert solver_cuda.block_shared_bytes(colliding(8), 8) == 236160 > limit
    assert solver_cuda.pick_team_width(plain, limit) == 8
    assert solver_cuda.pick_team_width(colliding, limit) == 16
    assert solver_cuda.block_shared_bytes(colliding(16), 16) == 118144
    with pytest.raises(ValueError, match="shared memory"):
        solver_cuda.pick_team_width(lambda width: limit, limit)
