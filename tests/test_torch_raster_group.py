"""The port's group path of the tile rasterizer (`ops/raster.py`:
`build_frame_tables`, `geometric_needed`, `visit_plan`, `rasterize` with
its two-phase occlusion feedback, and kernel #5's group mode) against the
JAX package's (`raster_pallas.rasterize`, `closest_hit_raster(binning=
"group")`, in interpret mode as tests/test_raster_pallas.py runs it), on
JAX's camera rows (injected, as tests/test_torch_raster.py does: one ulp
in them moves small triangles' planes by up to 1e-3); against the port's
own pair path; and the CUDA kernel's source (`csrc/raster.cu`,
`raster_groups`) compiled as host C++ against the plain version, bit for
bit.  Tolerances are tests/test_torch_raster.py's: `hit` equal off edges,
`t` within 1e-5 relative (JAX's dot rounds otherwise), `tri` equal where
the winner is off an edge and unique to 2^-15 (JAX's packed key drops q's
low 7 bits); `uv` see `_compare`."""

import ctypes
import dataclasses
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3d12renderer_tpu.ops import raster_pallas as rp
from d3d12renderer_tpu.render import bvh as jbvh
from d3d12renderer_tpu.render import camera as jcam
from d3d12renderer_tpu.render import mesh as jmesh
from d3d12renderer_tpu_torch import convert, cuda_build
from d3d12renderer_tpu_torch.ops import raster
from d3d12renderer_tpu_torch.render import bvh as tbvh

from tests.test_torch_raster import (CASES, EDGE, TIE_REL, _candidates,
                                     _demo)
from tests.torch_group_scenes import (SLIVER_EYE, SLIVER_SIZE, band_counters,
                                      band_wall, facing_grid, sliver_mesh,
                                      tied_rows)
from tests.torch_host_build import build_host

torch.set_num_threads(1)
# The feedback cases of tests/test_raster_pallas.py:143-175: the sphere
# grid at 128x64, feedback from this frame, from another camera, and a
# too-near 1e6 everywhere.
STALE_EYE = (4.0, 2.5, -5.0)


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name, meshes in (("demo", _demo(jmesh)),
                         ("grid", jmesh.sphere_grid_scene(3, 8))):
        jb = jbvh.build_bvh(meshes, cache=False)
        out[name] = (jb, convert.bvh_from_numpy(jb, "cpu"))
    return out


def _camera(case, eye=None):
    _, e, target, w, h, _ = CASES[case]
    return jcam.look_at(eye or e, target, v_fov=math.radians(60),
                        aspect=w / h)


def _inject_rows(monkeypatch, cam, w, h):
    mat, attr = rp.perspective_rows(cam, w, h)
    monkeypatch.setattr(raster, "perspective_rows", lambda *a: (
        torch.as_tensor(np.array(mat)), torch.as_tensor(np.array(attr))))
    return mat, attr


def _numpy(res):
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in res.items()}


@pytest.mark.parametrize("case", ["demo", "sphere-grid",
                                  "near-plane-crossing"])
def test_tables_and_plan_match_jax(scenes, case):
    """On JAX's rows: each group's rect and q bound (1e-5 relative), the
    (tile, group) overlaps, and the visit plan: JAX's visit words decoded
    to (tile, qq, group) equal the port's list in order, the same scale,
    JAX's per-tile counts the port's (at least 1), no visit dropped."""
    scene, _, _, w, h, _ = CASES[case]
    jb, tb = scenes[scene]
    wp, hp = w + (-w) % raster.TILE_X, h + (-h) % raster.TILE_Y
    mat, attr = rp.perspective_rows(_camera(case), w, h)
    jt = rp.build_frame_tables(jb.tri_v0, jb.tri_e1, jb.tri_e2, jb.tri_valid,
                               mat, attr, wp, hp)
    tt = raster.build_frame_tables(
        tb.tri_v0, tb.tri_e1, tb.tri_e2, tb.tri_valid,
        torch.as_tensor(np.array(mat)), torch.as_tensor(np.array(attr)), wp,
        hp)
    np.testing.assert_allclose(tt.rect.numpy(), np.asarray(jt.rect),
                               rtol=1e-5)
    np.testing.assert_allclose(tt.qhi.numpy(), np.asarray(jt.qhi), rtol=1e-5)
    assert tt.n_tris == jt.n_tris and tt.planes.shape[0] % raster.GROUP == 0
    need = raster.geometric_needed(tt, wp, hp)
    np.testing.assert_array_equal(need.numpy(), np.asarray(
        rp.geometric_needed(jt, wp, hp)))
    packed, counts, scale, overflow = rp.visit_plan(jt, wp, hp)
    assert int(overflow) == 0
    plan = raster.visit_plan(tt, wp, hp, torch.tensor(CASES[case][5]))
    n_tiles = (wp // raster.TILE_X) * (hp // raster.TILE_Y)
    _, q_bits, g_bits = rp._visit_bits(n_tiles, jt.qhi.shape[0])
    assert plan.q_bits == q_bits
    np.testing.assert_allclose(plan.scale.numpy(), np.asarray(scale),
                               rtol=1e-6)
    words = np.asarray(packed).astype(np.int64)
    words = words[words != 0x7FFFFFFF]
    qq = (words >> g_bits) & ((1 << q_bits) - 1)
    real = qq != (1 << q_bits) - 1                 # not a forced empty visit
    want = np.stack([words >> (q_bits + g_bits), qq,
                     words & ((1 << g_bits) - 1)], 1)[real]
    seg = plan.seg.numpy()
    tiles = np.repeat(plan.tiles.numpy(), np.diff(seg))
    got = np.stack([tiles, plan.qq.numpy(), plan.group.numpy()], 1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.maximum(np.diff(seg), 1),
                                  np.asarray(counts))
    assert plan.visits > 0
    # Each visit's bound: no sample of its tile gets a larger q from the
    # planes of its group's triangles that the pair path bins to the tile
    # (checked by evaluating every sample), and those triangles are the
    # pair path's for the tile.
    jit = torch.tensor(CASES[case][5])
    px, py = raster._tile_pixels(wp // raster.TILE_X, n_tiles, jit)
    rows = tt.planes.reshape(-1, raster.GROUP, raster.PLANE_COLS)[
        plan.group.long()]                                  # (V, G, 12)
    x = px[plan.visit_tile][:, None, :]
    y = py[plan.visit_tile][:, None, :]
    q = (rows[..., 9, None] * x + rows[..., 10, None] * y) + rows[..., 11,
                                                                   None]
    cover = raster.visit_cover(tt, plan.visit_tile, plan.group, wp)
    q = torch.where(cover[..., None], torch.nan_to_num(q, nan=-torch.inf),
                    -torch.inf).amax(dim=(1, 2))
    assert bool((q <= plan.bound).all())
    _, rect, q_tri = raster.project_planes(
        tb.tri_v0, tb.tri_e1, tb.tri_e2, tb.tri_valid,
        torch.as_tensor(np.array(mat)), torch.as_tensor(np.array(attr)), wp,
        hp)
    pair_tri, pseg = raster.bin_pairs(rect, q_tri, wp, hp)
    tri_of = (plan.group.long()[:, None] * raster.GROUP
              + torch.arange(raster.GROUP))[cover]
    tile_of = plan.visit_tile[:, None].expand_as(cover)[cover]
    pair_tile = torch.repeat_interleave(torch.arange(n_tiles),
                                        (pseg[1:] - pseg[:-1]).long())
    assert sorted(zip(tile_of.tolist(), tri_of.tolist())) == sorted(
        zip(pair_tile.tolist(), pair_tri.tolist()))


def _compare(got, want, tb, case):
    """tests/test_torch_raster.py's comparison of two frames, less `uv`:
    JAX's group branch takes its barycentrics from the dense rows at
    o + t d, and t from a small triangle's float32 q plane puts that point
    off the triangle (by up to 0.02 here); the port's are e / q at the
    sample, bit-equal to its pair path's (`test_group_path_equals_pair_
    path`), which tests/test_torch_raster.py holds against JAX's."""
    two, emin = _candidates(tb, case)
    differ = got["hit"] != want["hit"]
    assert np.all(np.abs(emin[differ]) <= EDGE), "hit differs off an edge"
    both = got["hit"] & want["hit"]
    np.testing.assert_allclose(got["t"][both], want["t"][both], rtol=1e-5)
    clear = both & (emin > EDGE) & (two[:, 0] - two[:, 1]
                                    > TIE_REL * two[:, 0])
    assert clear.sum() > 0.9 * both.sum()
    np.testing.assert_array_equal(got["tri"][clear], want["tri"][clear])
    np.testing.assert_allclose(got["tile_qmin"], want["tile_qmin"],
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("case,feedback", [
    ("demo", None), ("near-plane-crossing", None), ("sphere-grid", None),
    ("sphere-grid", "own"), ("sphere-grid", "stale"),
    ("sphere-grid", "garbage")])
def test_group_raster_matches_jax(scenes, monkeypatch, case, feedback):
    """`closest_hit_raster(binning="group")` and with `tile_qmin=` (this
    frame's, another camera's, 1e6 everywhere): against JAX's in interpret
    mode, and the feedback runs equal the run without feedback bit for
    bit (the repair phase makes the feedback exact)."""
    scene, _, _, w, h, jit = CASES[case]
    jb, tb = scenes[scene]
    cam = _camera(case)
    tc = convert.camera_from_numpy(cam, "cpu")
    _inject_rows(monkeypatch, cam, w, h)
    base = raster.closest_hit_raster(tb, tc, w, h, jitter=jit,
                                     binning="group")
    if feedback is None:
        want = rp.closest_hit_raster(jb, cam, w, h, jitter=jit,
                                     interpret=True, binning="group")
        assert int(want["overflow"]) == 0 and int(base["overflow"]) == 0
        _compare(_numpy(base), _numpy(want), tb, case)
        assert base["visits"]["phase2"] == 0 == base["visits"]["dirty"]
        return
    if feedback == "own":
        jq, tq = None, base["tile_qmin"]
    elif feedback == "garbage":
        tq = torch.full_like(base["tile_qmin"], 1e6)
        jq = jnp.asarray(tq.numpy())
    else:
        other = _camera(case, STALE_EYE)
        tq = raster.closest_hit_raster(
            tb, convert.camera_from_numpy(other, "cpu"), w, h, jitter=jit,
            binning="group")["tile_qmin"]
        jq = rp.closest_hit_raster(jb, other, w, h, jitter=jit,
                                   interpret=True,
                                   binning="group")["tile_qmin"]
    if jq is None:
        jq = rp.closest_hit_raster(jb, cam, w, h, jitter=jit, interpret=True,
                                   binning="group")["tile_qmin"]
    want = rp.closest_hit_raster(jb, cam, w, h, jitter=jit, interpret=True,
                                 tile_qmin=jq)
    got = raster.closest_hit_raster(tb, tc, w, h, jitter=jit, tile_qmin=tq)
    _compare(_numpy(got), _numpy(want), tb, case)
    for k in ("t", "tri", "uv", "hit", "tile_qmin"):
        assert torch.equal(got[k], base[k]), k
    v = got["visits"]
    if feedback == "garbage":
        assert v["dirty"] > 0 and v["phase1"] < base["visits"]["phase1"]
    if feedback == "own":
        assert v["dirty"] == 0 and v["phase1"] <= base["visits"]["phase1"]


@pytest.mark.parametrize("case", ["demo", "jittered", "near-plane-crossing"])
def test_group_path_equals_pair_path(scenes, case):
    """The port's group path against its pair path: q (and t) equal bit
    for bit, and `tri` equal except where two triangles give the pixel
    exactly the same q (a tie, which each path settles by its own order);
    the barycentrics (e / q at the sample on both) bit-equal where `tri`
    is."""
    scene, _, _, w, h, jit = CASES[case]
    _, tb = scenes[scene]
    tc = convert.camera_from_numpy(_camera(case), "cpu")
    g = raster.closest_hit_raster(tb, tc, w, h, jitter=jit, binning="group")
    p = raster.closest_hit_raster(tb, tc, w, h, jitter=jit)
    assert torch.equal(g["hit"], p["hit"]) and torch.equal(g["t"], p["t"])
    assert torch.equal(g["tile_qmin"], p["tile_qmin"])
    mat, attr = raster.perspective_rows(tc, w, h)
    planes, _, _ = raster.project_planes(tb.tri_v0, tb.tri_e1, tb.tri_e2,
                                         tb.tri_valid, mat, attr, w, h)
    diff = torch.nonzero(g["tri"] != p["tri"])[:, 0]
    x = (diff % w).float() + jit[0]
    y = (diff // w).float() + jit[1]

    def q_of(tri):
        r = planes[tri.long()]
        return (r[:, 9] * x + r[:, 10] * y) + r[:, 11]

    assert torch.equal(q_of(g["tri"][diff]), q_of(p["tri"][diff]))
    same = g["tri"] == p["tri"]
    assert torch.equal(g["uv"][same], p["uv"][same])


def _edge_on_slivers(n=4096, seed=0):
    """`torch_group_scenes.sliver_mesh`'s slivers seen from its eye through
    JAX's camera: (BVH, camera, w, h)."""
    w, h = SLIVER_SIZE
    cam = convert.camera_from_numpy(jcam.look_at(
        SLIVER_EYE, (0.0, 0.0, 0.0), v_fov=math.radians(60), aspect=w / h),
        "cpu")
    return tbvh.build_bvh([(sliver_mesh(n, seed), 0)], device="cpu"), cam, \
        w, h


def test_edge_on_planes_stay_in_their_tiles():
    """Edge-on slivers (`_edge_on_slivers`): testing every row of a
    visited group, as JAX's kernel does, lets their noise planes win
    pixels in tiles their rects do not reach, which the pair path never
    gives them; the group path tests only the rows binned to the tile and
    equals the pair path: t and hit bit for bit, tri except at exact
    ties."""
    tb, tc, w, h = _edge_on_slivers()
    jit = (0.5, 0.5)
    g = raster.closest_hit_raster(tb, tc, w, h, jitter=jit, binning="group")
    p = raster.closest_hit_raster(tb, tc, w, h, jitter=jit)
    assert torch.equal(g["t"], p["t"]) and torch.equal(g["hit"], p["hit"])
    assert int(p["hit"].sum()) > 10
    mat, attr = raster.perspective_rows(tc, w, h)
    tables = raster.build_frame_tables(tb.tri_v0, tb.tri_e1, tb.tri_e2,
                                       tb.tri_valid, mat, attr, w, h)
    diff = torch.nonzero(g["tri"] != p["tri"])[:, 0]
    x = (diff % w).float() + jit[0]
    y = (diff // w).float() + jit[1]

    def q_of(tri):
        r = tables.planes[tri.long()]
        return (r[:, 9] * x + r[:, 10] * y) + r[:, 11]

    assert torch.equal(q_of(g["tri"][diff]), q_of(p["tri"][diff]))
    # Every row of a group tested in every tile its group visits.
    ntx, nty = w // raster.TILE_X, h // raster.TILE_Y
    real = tables.tri_tiles[:, 2] >= 0
    every = dataclasses.replace(tables, tri_tiles=torch.where(
        real[:, None], torch.tensor([0, 0, ntx - 1, nty - 1],
                                    dtype=torch.int32), tables.tri_tiles))
    jt = torch.tensor(jit)
    q_all, tri_all = raster.rasterize_groups_plain(
        every, raster.visit_plan(every, w, h, jt), jt, w, h)
    q_own, _ = raster.rasterize_groups_plain(
        tables, raster.visit_plan(tables, w, h, jt), jt, w, h)
    extra = torch.nonzero(q_all != q_own)[:, 0]
    assert extra.numel() > 0
    r = tables.tri_tiles[tri_all[extra].long()]
    tx, ty = extra % w // raster.TILE_X, extra // w // raster.TILE_Y
    assert not bool(((r[:, 0] <= tx) & (tx <= r[:, 2]) & (r[:, 1] <= ty)
                     & (ty <= r[:, 3])).any())


def test_jax_visit_cap_pins_the_difference(monkeypatch):
    """One 64x32 tile seen through a 20,480-triangle sphere (160 groups)
    in front of a far wall (one group): JAX keeps the 128 nearest visits
    and drops the rest (`overflow` 33), the wall's among them, so its
    pixels around the sphere miss; the port keeps every visit (`overflow`
    0) and hits the wall there, as its pair path does."""
    jb, tb, cam, w, h = _sphere_wall()
    _inject_rows(monkeypatch, cam, w, h)
    want = _numpy(rp.closest_hit_raster(jb, cam, w, h, interpret=True,
                                        binning="group"))
    got = raster.closest_hit_raster(tb, convert.camera_from_numpy(cam, "cpu"),
                                    w, h, binning="group")
    pair = raster.closest_hit_raster(tb, convert.camera_from_numpy(cam, "cpu"),
                                     w, h)
    n_groups = tb.tri_v0.shape[0] // raster.GROUP + 1
    assert int(want["overflow"]) == n_groups - rp.VISIT_CAP > 0
    assert int(got["overflow"]) == 0 and got["visits"]["phase1"] == n_groups
    wall_rows = _np_wall_rows(tb)
    lost = got["hit"].numpy() & ~want["hit"]
    assert lost.sum() > 100
    assert np.isin(got["tri"].numpy()[lost], wall_rows).all()
    assert torch.equal(got["t"], pair["t"]) and torch.equal(got["hit"],
                                                            pair["hit"])
    kept = want["hit"]
    np.testing.assert_allclose(got["t"].numpy()[kept], want["t"][kept],
                               rtol=1e-5)


def _sphere_wall():
    """A 20,480-triangle sphere in front of a wall that fills the one
    64x32 tile: (JAX BVH, port BVH, camera, w, h)."""
    sphere = jmesh.ico_sphere(0.6, 5)
    wall = jmesh.quad(half=6.0).transformed(
        translate=(0.0, 0.0, 8.0),
        rotate=(math.sin(-math.pi / 4), 0.0, 0.0, math.cos(math.pi / 4)))
    jb = jbvh.build_bvh([(sphere, 0), (wall, 1)], cache=False)
    w, h = 64, 32
    cam = jcam.look_at((0.0, 0.0, -2.0), (0.0, 0.0, 0.0),
                       v_fov=math.radians(60), aspect=w / h)
    return jb, convert.bvh_from_numpy(jb, "cpu"), cam, w, h


def _np_wall_rows(tb):
    """Rows of the material-1 wall in the BVH's leaf order."""
    return np.nonzero(tb.tri_material.numpy() == 1)[0]


# --------------------------------------------------------------------------
# The kernel's source, compiled as host C++
# --------------------------------------------------------------------------

HARNESS = """\
#include "raster.cu"
// One one-thread block per row band of each work item: that thread owns
// the band's pixels, stages, culls and compacts every row itself.
extern "C" int host_raster_groups(const RasterGroupArgs* a) {
  blockDim = dim3(1);
  threadIdx = dim3(0);
  for (int b = 0; b < a->n_items * RASTER_GROUP_BANDS; ++b) {
    blockIdx = dim3(b);
    raster_groups<RASTER_GROUP_BAND_PX>(*a);
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_groups(tmp_path_factory):
    host = build_host(tmp_path_factory, "host_raster_groups", HARNESS,
                      ("host_raster_groups", "raster_group_args_size"))
    host.host_raster_groups.argtypes = [ctypes.c_void_p]
    return host


def _tables(scenes, case):
    scene, _, _, w, h, jit = CASES[case]
    _, tb = scenes[scene]
    tc = convert.camera_from_numpy(_camera(case), "cpu")
    wp, hp = w + (-w) % raster.TILE_X, h + (-h) % raster.TILE_Y
    mat, attr = raster.perspective_rows(tc, w, h)
    tables = raster.build_frame_tables(tb.tri_v0, tb.tri_e1, tb.tri_e2,
                                       tb.tri_valid, mat, attr, wp, hp)
    return tables, torch.tensor(jit), wp, hp


@pytest.mark.parametrize("case", ["demo", "sphere-grid",
                                  "near-plane-crossing", "jittered"])
def test_host_kernel_matches_plain(host_groups, scenes, case):
    """Through the real wrapper (`raster.launch_groups`): q and tri equal
    to the plain version bit for bit, on every tile; then on a subset of
    tiles over a base image (the repair phase's launch), only those tiles
    rewritten.  The counters equal their replay with the plain arithmetic
    (`band_counters`): visits run and skipped add up to GROUP_BANDS per
    visit, and the rows tested cover those any exact cull per band must
    test (`group_rows_needed`)."""
    tables, jit, wp, hp = _tables(scenes, case)
    plan = raster.visit_plan(tables, wp, hp, jit)
    stats = torch.zeros(4, dtype=torch.int64)
    got = raster.launch_groups(host_groups.host_raster_groups, tables,
                               plan, jit, wp, hp, stats=stats)
    want = raster.rasterize_groups_plain(tables, plan, jit, wp, hp)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    run, skipped, tested, culled = stats.tolist()
    assert run + skipped == raster.GROUP_BANDS * plan.visits
    assert stats.tolist() == band_counters(tables, plan, jit, wp)
    assert tested >= raster.group_rows_needed(tables, plan, want[0], jit,
                                              wp, hp)
    assert culled > 0 and (want[1] >= 0).any()
    base = (torch.full_like(want[0], 0.25),
            torch.full_like(want[1], 7))
    sub = plan.tiles[::2].contiguous()
    part = raster.visit_plan(tables, wp, hp, jit, tiles=sub)
    got = raster.launch_groups(host_groups.host_raster_groups, tables,
                               part, jit, wp, hp, base=base)
    want2 = raster.rasterize_groups_plain(tables, part, jit, wp, hp,
                                          base=base)
    assert all(torch.equal(a, b) for a, b in zip(got, want2))
    tile_of = raster.tile_min(torch.arange(wp * hp, dtype=torch.float32) * 0
                              + 1, wp, hp)
    launched = torch.zeros_like(tile_of, dtype=torch.bool)
    launched[sub.long()] = True
    img = launched.reshape(hp // raster.TILE_Y, 1, wp // raster.TILE_X, 1)
    img = img.expand(-1, raster.TILE_Y, -1, raster.TILE_X).reshape(-1)
    assert torch.equal(got[0][img], want[0][img])
    assert torch.equal(got[0][~img], base[0][~img])


@pytest.mark.parametrize("case,chunk", [("demo", 1), ("sphere-grid", 2),
                                        ("near-plane-crossing", 3),
                                        ("jittered", 5)])
def test_host_kernel_split_tiles_match_plain(host_groups, scenes,
                                             monkeypatch, case, chunk):
    """Tiles of more than `chunk` visits (GROUP_CHUNK set so) split into
    chunks walked by their own blocks, merged by the 64-bit maximum of
    (q's bits, ~rank): q and tri bit-equal to the plain version (the first
    of equal q in visit order wins across chunks), also in the repair
    phase over a base image; the counters equal the chunked replay."""
    tables, jit, wp, hp = _tables(scenes, case)
    plan = raster.visit_plan(tables, wp, hp, jit)
    assert int((plan.seg[1:] - plan.seg[:-1]).max()) > chunk
    monkeypatch.setattr(raster, "GROUP_CHUNK", chunk)
    stats = torch.zeros(4, dtype=torch.int64)
    got = raster.launch_groups(host_groups.host_raster_groups, tables, plan,
                               jit, wp, hp, stats=stats)
    want = raster.rasterize_groups_plain(tables, plan, jit, wp, hp)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert stats.tolist() == band_counters(tables, plan, jit, wp, chunk)
    base = (torch.full_like(want[0], 0.25), torch.full_like(want[1], 7))
    part = raster.visit_plan(tables, wp, hp, jit, tiles=plan.tiles[1::2])
    got = raster.launch_groups(host_groups.host_raster_groups, tables, part,
                               jit, wp, hp, base=base)
    want = raster.rasterize_groups_plain(tables, part, jit, wp, hp,
                                         base=base)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("scene", [band_wall, tied_rows],
                         ids=["band-wall", "tied-rows"])
def test_host_kernel_one_visit_chunks(host_groups, monkeypatch, scene):
    """The synthetic tables with every visit a chunk of its own: the tied
    rows' second wall gives every pixel the first wall's q from its own
    chunk, and the merge keeps the first in visit order (tri 0), as the
    plain version does; the counters equal the chunked replay."""
    (tables, plan, jit, w, h), _ = scene()
    monkeypatch.setattr(raster, "GROUP_CHUNK", 1)
    stats = torch.zeros(4, dtype=torch.int64)
    got = raster.launch_groups(host_groups.host_raster_groups, tables, plan,
                               jit, w, h, stats=stats)
    want = raster.rasterize_groups_plain(tables, plan, jit, w, h)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert stats.tolist() == band_counters(tables, plan, jit, w, 1)


def test_group_items_cover_every_visit_once():
    """`group_items`: each launched tile's visits in chunks of `chunk`,
    the last one shorter, one item for a tile without visits, longest
    first, padded to n_launch + visits // chunk items with (-1, 0, 0, -1);
    the tiles of more than one chunk numbered 0, 1, ... in slot order,
    -1 for the others."""
    seg = torch.tensor([0, 7, 7, 8, 20], dtype=torch.int32)
    items = raster.group_items(seg, 20, 3)
    assert items.shape == (4 + 20 // 3, 4)
    real = items[items[:, 0] >= 0]
    assert items[items[:, 0] < 0].tolist() == [[-1, 0, 0, -1]] * (
        items.shape[0] - real.shape[0])
    length = real[:, 2] - real[:, 1]
    assert bool((length[:-1] >= length[1:]).all()) and int(length.max()) == 3
    got = sorted(map(tuple, real.tolist()))
    assert got == [(0, 0, 3, 0), (0, 3, 6, 0), (0, 6, 7, 0), (1, 7, 7, -1),
                   (2, 7, 8, -1), (3, 8, 11, 1), (3, 11, 14, 1),
                   (3, 14, 17, 1), (3, 17, 20, 1)]
    got = sorted(map(tuple, raster.group_items(seg, 20, 5).tolist()))
    assert got == [(-1, 0, 0, -1), (0, 0, 5, 0), (0, 5, 7, 0), (1, 7, 7, -1),
                   (2, 7, 8, -1), (3, 8, 13, 1), (3, 13, 18, 1),
                   (3, 18, 20, 1)]
    got = sorted(map(tuple, raster.group_items(seg, 20, 12).tolist()))
    assert got == [(-1, 0, 0, -1), (0, 0, 7, -1), (1, 7, 7, -1),
                   (2, 7, 8, -1), (3, 8, 20, -1)]


def test_host_kernel_matches_plain_on_edge_on_planes(host_groups):
    """On the edge-on slivers, whose noise planes cover samples in tiles
    their rects do not reach (`test_edge_on_planes_stay_in_their_tiles`),
    the kernel tests the rows binned to each tile as the plain version
    does: q and tri bit for bit."""
    tb, tc, w, h = _edge_on_slivers()
    mat, attr = raster.perspective_rows(tc, w, h)
    tables = raster.build_frame_tables(tb.tri_v0, tb.tri_e1, tb.tri_e2,
                                       tb.tri_valid, mat, attr, w, h)
    jit = torch.tensor([0.5, 0.5])
    plan = raster.visit_plan(tables, w, h, jit)
    got = raster.launch_groups(host_groups.host_raster_groups, tables, plan,
                               jit, w, h)
    want = raster.rasterize_groups_plain(tables, plan, jit, w, h)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int((want[1] >= 0).sum()) > 10


def test_host_kernel_early_out_skips(host_groups):
    """A wall that covers the one 64x32 tile in front of a 1,152-triangle
    grid facing the camera: the wall's visit comes first and sets every
    pixel; the grid's planes are parallel to the screen, so each of its
    visits' exact bounds is its own q, below the wall's, and the kernel
    skips those visits (its counters), equal to the plain version, which
    skips them too."""
    wall = facing_grid(1, 6.0, 0.5)
    tb = tbvh.build_bvh([(wall, 1), (facing_grid(24, 1.0, 3.0), 0)],
                        device="cpu")
    w, h = 64, 32
    tc = convert.camera_from_numpy(jcam.look_at(
        (0.0, 0.0, -2.0), (0.0, 0.0, 0.0), v_fov=math.radians(60),
        aspect=w / h), "cpu")
    mat, attr = raster.perspective_rows(tc, w, h)
    tables = raster.build_frame_tables(tb.tri_v0, tb.tri_e1, tb.tri_e2,
                                       tb.tri_valid, mat, attr, w, h)
    jit = torch.tensor([0.5, 0.5])
    plan = raster.visit_plan(tables, w, h, jit)
    stats = torch.zeros(4, dtype=torch.int64)
    got = raster.launch_groups(host_groups.host_raster_groups, tables,
                               plan, jit, w, h, stats=stats)
    want = raster.rasterize_groups_plain(tables, plan, jit, w, h)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    run, skipped, _, _ = stats.tolist()
    bands = raster.GROUP_BANDS
    assert run + skipped == bands * plan.visits
    assert skipped >= 8 * bands and run >= bands
    assert stats.tolist() == band_counters(tables, plan, jit, w)
    assert bool((tb.tri_material[want[1].long()] == 1).all())


@pytest.mark.parametrize("scene", [band_wall, tied_rows],
                         ids=["band-wall", "tied-rows"])
def test_host_kernel_band_counters(host_groups, scene):
    """Synthetic one-tile tables whose counters are known by hand
    (`torch_group_scenes`): a wall over the first row band only, so that
    band skips the farther wall's visit and the others run it; and a row
    whose q at every band's corner equals the band's least q, which is
    culled (a tie never wins), beside a sloped plane culled in all but
    the first band.  q and tri equal the plain version's, and the
    counters the hand count and the replay."""
    (tables, plan, jit, w, h), want_stats = scene()
    stats = torch.zeros(4, dtype=torch.int64)
    got = raster.launch_groups(host_groups.host_raster_groups, tables, plan,
                               jit, w, h, stats=stats)
    want = raster.rasterize_groups_plain(tables, plan, jit, w, h)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tuple(stats.tolist()) == want_stats
    assert stats.tolist() == band_counters(tables, plan, jit, w)
    assert bool((want[1] >= 0).all())


def test_kernel_layout_matches_the_wrapper(host_groups):
    src = (cuda_build.CSRC_DIR / "raster.cu").read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (RASTER_[A-Z_]+) = (\d+);", src)}
    assert consts["RASTER_GROUP"] == raster.GROUP
    assert consts["RASTER_GROUP_BANDS"] == raster.GROUP_BANDS
    assert host_groups.raster_group_args_size() == ctypes.sizeof(
        raster.RasterGroupArgs)
    fields = re.search(r"struct RasterGroupArgs \{(.*?)\};", src,
                       re.S).group(1)
    names = re.findall(r"(\w+);", fields)
    assert names == [f for f, _ in raster.RasterGroupArgs._fields_]


def test_wrapper_takes_the_plain_version_on_cpu(scenes):
    """On CPU tensors `rasterize_groups` is the plain version and counts no
    launch; `launch_groups` refuses bad inputs."""
    tables, jit, wp, hp = _tables(scenes, "demo")
    plan = raster.visit_plan(tables, wp, hp, jit)
    before = raster.rasterize_groups.launches
    a = raster.rasterize_groups(tables, plan, jit, wp, hp)
    b = raster.rasterize_groups_plain(tables, plan, jit, wp, hp)
    assert raster.rasterize_groups.launches == before
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError):
        raster.launch_groups(lambda a: 0, dataclasses.replace(
            tables, planes=tables.planes[:-1]), plan, jit, wp, hp)
    with pytest.raises(ValueError):
        raster.launch_groups(lambda a: 0, dataclasses.replace(
            tables, tri_tiles=tables.tri_tiles.long()), plan, jit, wp, hp)
    with pytest.raises(ValueError):
        raster.launch_groups(lambda a: 0, tables, plan, jit, wp + 1,
                             hp)
    with pytest.raises(RuntimeError):
        raster.launch_groups(lambda a: 1, tables, plan, jit, wp, hp)
