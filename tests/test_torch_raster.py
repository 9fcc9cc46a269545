"""The port's tile rasterizer (`ops/raster.py`) against the JAX package's
Pallas rasterizer (`raster_pallas.closest_hit_raster`, pair binning, in
interpret mode as tests/test_raster_pallas.py runs it), against the port's
own ray path, and the CUDA kernel's source (`csrc/raster.cu`) compiled as
host C++ against the plain version.  Scenes are those of
tests/test_raster_pallas.py."""

import ctypes
import math
import re

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
from d3d12renderer_tpu_torch.render import camera as tcam
from d3d12renderer_tpu_torch.render import mesh as tmesh

from tests.torch_host_build import build_host

torch.set_num_threads(1)
# JAX's visit packing needs a static pair capacity; these scenes bin into
# fewer than 2,000 pairs (the test checks JAX's overflow counter).
PAIR_CAP = 8192
# `tri` and `uv` are compared where the winner is off an edge (every
# barycentric above EDGE) and its q is unique to 2^-15 relative: JAX's
# packed key drops q's low 7 mantissa bits and prefers the lower column
# (raster_pallas.py:382-399), so at near-ties its `tri` may not be its q's.
EDGE = 1e-4
TIE_REL = 2.0 ** -15


def _demo(mm):
    return [(mm.quad(half=30.0), 0),
            (mm.ico_sphere(1.0, 2).transformed(translate=(0, 1.0, 0)), 1),
            (mm.box((0.7, 0.7, 0.7)).transformed(
                translate=(2.2, 0.7, -0.5),
                rotate=(0.0, math.sin(0.3), 0.0, math.cos(0.3))), 3),
            (mm.torus(0.9, 0.3).transformed(translate=(0.8, 0.3, 2.2)), 4)]


CASES = {
    # id: (scene, eye, target, width, height, jitter)
    "demo": ("demo", (0.0, 1.5, -6.0), (0.0, 1.0, 0.0), 128, 96, (0.5, 0.5)),
    "sphere-grid": ("grid", (0.0, 1.5, -6.0), (0.0, 1.0, 0.0), 128, 64,
                    (0.5, 0.5)),
    "near-plane-crossing": ("demo", (0.0, 0.4, -2.0), (0.0, 0.2, 2.0), 128,
                            64, (0.5, 0.5)),
    "jittered": ("demo", (0.0, 1.5, -6.0), (0.0, 1.0, 0.0), 96, 64,
                 (0.25, 0.75)),
    "empty-view": ("demo", (0.0, 1.0, -6.0), (0.0, 20.0, -12.0), 64, 32,
                   (0.5, 0.5)),
}


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name, meshes in (("demo", _demo(jmesh)),
                         ("grid", jmesh.sphere_grid_scene(3, 8))):
        jb = jbvh.build_bvh(meshes, cache=False)
        out[name] = (jb, convert.bvh_from_numpy(jb, "cpu"))
    return out


def _camera(case):
    _, eye, target, w, h, _ = CASES[case]
    return jcam.look_at(eye, target, v_fov=math.radians(60), aspect=w / h)


def _numpy(res):
    return {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in res.items()}


@pytest.fixture(scope="module")
def jax_results(scenes):
    cache = {}

    def get(case):
        if case not in cache:
            scene, _, _, w, h, jit = CASES[case]
            cache[case] = _numpy(rp.closest_hit_raster(
                scenes[scene][0], _camera(case), w, h, jitter=jit,
                interpret=True, pair_cap=PAIR_CAP))
        return cache[case]
    return get


def _port(scenes, case, monkeypatch=None):
    """The port's query; with `monkeypatch`, on JAX's camera rows."""
    scene, _, _, w, h, jit = CASES[case]
    cam = _camera(case)
    if monkeypatch is not None:
        mat, attr = rp.perspective_rows(cam, w, h)
        monkeypatch.setattr(raster, "perspective_rows", lambda *a: (
            torch.as_tensor(np.array(mat)), torch.as_tensor(np.array(attr))))
    res = raster.closest_hit_raster(scenes[scene][1],
                                    convert.camera_from_numpy(cam, "cpu"),
                                    w, h, jitter=jit)
    return res, _numpy(res)


def _candidates(tb, case):
    """Float64 per pixel: every triangle's (q, u, v, e-min/q) at the
    sample, for the tie and edge margins: (q_sorted (N, 2), edge_min of
    the best)."""
    _, _, _, w, h, jit = CASES[case]
    cam = convert.camera_from_numpy(_camera(case), "cpu")
    mat, attr = raster.perspective_rows(cam, w, h)
    planes, _, _ = raster.project_planes(tb.tri_v0, tb.tri_e1, tb.tri_e2,
                                         tb.tri_valid, mat, attr, w, h)
    p = planes.double().numpy()
    p = p[np.isfinite(p).all(1)]
    x = np.arange(w) + jit[0]
    y = np.arange(h) + jit[1]
    px = np.broadcast_to(x[None, :], (h, w)).reshape(-1, 1)
    py = np.broadcast_to(y[:, None], (h, w)).reshape(-1, 1)

    def dot(c):
        return p[:, c] * px + p[:, c + 1] * py + p[:, c + 2]

    e0, e1, e2, q = dot(0), dot(3), dot(6), dot(9)
    emin = np.minimum(np.minimum(e0, e1), e2) / np.where(q > 0, q, 1)
    ok = (emin >= -EDGE) & (q > 0)
    qm = np.where(ok, q, -1.0)
    best = np.argmax(qm, 1)
    two = -np.sort(-qm, 1)[:, :2]
    rows = np.arange(qm.shape[0])
    return two, emin[rows, best]


@pytest.mark.parametrize("case", sorted(CASES))
def test_raster_matches_jax(case, scenes, jax_results, monkeypatch):
    """Both rasterizers on the same camera rows (JAX's, injected: see the
    next test for the port's own): `hit` equal except at edge pixels; `t`
    within 1e-5 relative (the plane dots round differently: JAX's MXU dot
    vs the port's separately rounded products); `tri` equal and `uv`
    within 1e-4 where the winner's q is unique to 2^-15 and it is off an
    edge.  The pair list is exact (`overflow` 0 on both sides)."""
    want = jax_results(case)
    assert int(want["overflow"]) == 0
    res, got = _port(scenes, case, monkeypatch)
    assert int(got["overflow"]) == 0
    if case == "empty-view":
        assert not got["hit"].any() and not want["hit"].any()
        assert np.all(got["tri"] == -1) and np.all(np.isinf(got["t"]))
        return
    assert want["hit"].mean() > 0.2
    two, emin = _candidates(scenes[CASES[case][0]][1], case)
    differ = got["hit"] != want["hit"]
    assert np.all(np.abs(emin[differ]) <= EDGE), "hit differs off an edge"
    both = got["hit"] & want["hit"]
    np.testing.assert_allclose(got["t"][both], want["t"][both], rtol=1e-5)
    clear = both & (emin > EDGE) & (two[:, 0] - two[:, 1] > TIE_REL * two[:, 0])
    assert clear.sum() > 0.9 * both.sum()
    np.testing.assert_array_equal(got["tri"][clear], want["tri"][clear])
    np.testing.assert_allclose(got["uv"][clear], want["uv"][clear], atol=1e-4)
    np.testing.assert_allclose(got["tile_qmin"], want["tile_qmin"],
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("case", ["demo", "jittered"])
def test_camera_rows_match_jax(case):
    """The port's own camera rows: within an ulp of JAX's (the quaternion
    rotation rounds in another order).  An ulp here moves the edge planes
    of small or far triangles by up to ~1e-3 relative (they come from
    cross products that cancel), which is why the test above injects
    JAX's rows; the frames stay within the whole-frame tolerance
    (tests/test_torch_pipeline.py)."""
    _, _, _, w, h, _ = CASES[case]
    cam = _camera(case)
    want = [np.asarray(x) for x in rp.perspective_rows(cam, w, h)]
    got = raster.perspective_rows(convert.camera_from_numpy(cam, "cpu"), w, h)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-7,
                                   atol=2e-7 * np.abs(b).max())


def test_planes_match_jax_on_the_same_rows(scenes):
    """`project_planes` against `_project_planes`, row by row, each row
    scaled by its largest component (NaN rows equal)."""
    case = "demo"
    _, _, _, w, h, _ = CASES[case]
    cam = _camera(case)
    jb, tb = scenes["demo"]
    mat, attr = rp.perspective_rows(cam, w, h)
    e0, e1, e2, qp, x0, y0, x1, y1, q_tri = rp._project_planes(
        jb.tri_v0, jb.tri_e1, jb.tri_e2, jb.tri_valid, mat, attr, w, h)
    want = np.stack([np.asarray(c) for c in e0 + e1 + e2 + qp], 1)
    planes, rect, got_q = raster.project_planes(
        tb.tri_v0, tb.tri_e1, tb.tri_e2, tb.tri_valid,
        torch.as_tensor(np.array(mat)), torch.as_tensor(np.array(attr)),
        w, h)
    got = planes.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = np.isfinite(want).all(1)
    scale = np.abs(want[ok]).max(1, keepdims=True)
    assert np.abs(got[ok] - want[ok]).max() / 1 <= 1e-5 * scale.max()
    assert np.all(np.abs(got[ok] - want[ok]) <= 1e-3 * scale)
    for a, b in zip(rect + (got_q,), (x0, y0, x1, y1, q_tri)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)


def test_binning_is_exact_and_ordered(scenes):
    """Each visible triangle is listed once in every tile of its rect's
    tile range (`visit_plan_pairs` `:480-489`: floor of the left edge to
    ceil of the right edge less one, at least one tile), tiles ascending,
    each tile's pairs front to back by their bound."""
    jb, tb = scenes["grid"]
    case = "sphere-grid"
    _, _, _, w, h, _ = CASES[case]
    cam = convert.camera_from_numpy(_camera(case), "cpu")
    mat, attr = raster.perspective_rows(cam, w, h)
    _, rect, q_tri = raster.project_planes(tb.tri_v0, tb.tri_e1, tb.tri_e2,
                                           tb.tri_valid, mat, attr, w, h)
    pair_tri, seg = raster.bin_pairs(rect, q_tri, w, h)
    x0, y0, x1, y1 = (r.numpy().astype(np.float64) for r in rect)
    q = q_tri.numpy()
    ntx, nty = w // raster.TILE_X, h // raster.TILE_Y
    with np.errstate(invalid="ignore"):
        vis = (q > 0) & (x1 > 0) & (x0 < w) & (y1 > 0) & (y0 < h)
    lo_x = np.clip(np.floor(x0 / raster.TILE_X), 0, ntx - 1)
    lo_y = np.clip(np.floor(y0 / raster.TILE_Y), 0, nty - 1)
    hi_x = np.maximum(np.clip(np.ceil(x1 / raster.TILE_X) - 1, 0, ntx - 1), lo_x)
    hi_y = np.maximum(np.clip(np.ceil(y1 / raster.TILE_Y) - 1, 0, nty - 1), lo_y)
    assert int(seg[-1]) == int((vis * (hi_x - lo_x + 1) * (hi_y - lo_y + 1)).sum())
    for t in range(ntx * nty):
        tx, ty = t % ntx, t // ntx
        want = np.nonzero(vis & (lo_x <= tx) & (hi_x >= tx) & (lo_y <= ty)
                          & (hi_y >= ty))[0]
        got = pair_tri[seg[t]:seg[t + 1]].numpy()
        assert sorted(got.tolist()) == want.tolist()
        # Unbounded triangles (q = inf) first; equal quantised bounds may
        # differ by the quantisation's rounding.
        bounds = np.where(np.isinf(q[got]), 1e30, q[got]).astype(np.float64)
        assert np.all(np.diff(bounds) <= 1e-6 * bounds[:-1])


def _jax_tile_lists(jb, mat, attr, w, h, pair_cap):
    """JAX's pair binning (`visit_plan_pairs`) decoded into each tile's
    triangle list in its visit order, and each tile's visit bounds: the
    live visit words give (tile, visit, quantised bound), a visit's table
    block carries its triangle ids in row 12 (NaN for pad lanes)."""
    packed, _, scale2, table, p_ovf, v_ovf, bits = rp.visit_plan_pairs(
        jb.tri_v0, jb.tri_e1, jb.tri_e2, jb.tri_valid, mat, attr, w, h,
        pair_cap=pair_cap)
    assert int(p_ovf) == 0 and int(v_ovf) == 0
    words = np.asarray(packed)
    words = words[words != 0x7FFFFFFF]
    vidx = words & ((1 << bits["group_bits"]) - 1)
    tile = words >> (bits["q_bits"] + bits["group_bits"])
    qq2 = (words >> bits["group_bits"]) & ((1 << bits["q_bits"]) - 1)
    # The bound `_raster_kernel` compares (raster_pallas.py:356-359).
    bound2 = np.where(qq2 == 0, np.inf, ((1 << bits["q_bits"]) - 1 - qq2)
                      .astype(np.float32) * np.asarray(scale2)[0])
    ids = np.asarray(table).reshape(-1, 16, rp.GROUP)[:, 12, :]
    n_tiles = (w // raster.TILE_X) * (h // raster.TILE_Y)
    lists = [[] for _ in range(n_tiles)]
    bounds = [[] for _ in range(n_tiles)]
    for i in np.lexsort((vidx, tile)):
        row = ids[vidx[i]]
        if np.isfinite(row).any():
            bounds[tile[i]].append(bound2[i])
        lists[tile[i]].extend(row[np.isfinite(row)].astype(np.int64).tolist())
    return lists, bounds


def _assert_same_binning(jb, tb, mat, attr, w, h, pair_cap):
    """The port's `bin_pairs` on the same camera rows lists, per tile, the
    triangles of JAX's binning in the same order; returns the pair count."""
    _, rect, q_tri = raster.project_planes(
        tb.tri_v0, tb.tri_e1, tb.tri_e2, tb.tri_valid,
        torch.as_tensor(np.array(mat)), torch.as_tensor(np.array(attr)), w, h)
    pair_tri, seg = raster.bin_pairs(rect, q_tri, w, h)
    want, _ = _jax_tile_lists(jb, mat, attr, w, h, pair_cap)
    seg = seg.tolist()
    got = pair_tri.tolist()
    assert [seg[t + 1] - seg[t] for t in range(len(want))] == \
        [len(x) for x in want]
    for t, lst in enumerate(want):
        assert got[seg[t]:seg[t + 1]] == lst, t
    return len(got)


@pytest.mark.parametrize("case", sorted(CASES))
def test_binning_matches_jax(case, scenes):
    """Per tile, the same triangles in the same order as JAX's
    `visit_plan_pairs` on the test scenes (the near-plane-crossing case's
    unbounded triangles included), on JAX's camera rows and the padded
    size `closest_hit_raster` bins."""
    scene, _, _, w, h, _ = CASES[case]
    jb, tb = scenes[scene]
    mat, attr = rp.perspective_rows(_camera(case), w, h)
    wp, hp = w + (-w) % raster.TILE_X, h + (-h) % raster.TILE_Y
    assert _assert_same_binning(jb, tb, mat, attr, wp, hp, PAIR_CAP) > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_static_binning_matches_dynamic(case, scenes, monkeypatch):
    """`bin_pairs` of a scene under STATIC_PAIRS (slots for every pair that
    can exist, no host read): the same segments and, below seg[-1], the
    same pairs in the same order as the list of a larger scene's; and
    `closest_hit_raster` gives the same bits on either list."""
    scene, _, _, w, h, _ = CASES[case]
    _, tb = scenes[scene]
    cam = convert.camera_from_numpy(_camera(case), "cpu")
    wp, hp = w + (-w) % raster.TILE_X, h + (-h) % raster.TILE_Y
    mat, attr = raster.perspective_rows(cam, w, h)
    _, rect, q_tri = raster.project_planes(tb.tri_v0, tb.tri_e1, tb.tri_e2,
                                           tb.tri_valid, mat, attr, wp, hp)
    n_tiles = (wp // raster.TILE_X) * (hp // raster.TILE_Y)
    jit = torch.tensor([0.3, 0.7])
    assert tb.tri_v0.shape[0] * n_tiles <= raster.STATIC_PAIRS
    s_tri, s_seg = raster.bin_pairs(rect, q_tri, wp, hp)
    a = raster.closest_hit_raster(tb, cam, w, h, jitter=jit)
    monkeypatch.setattr(raster, "STATIC_PAIRS", 0)
    pair_tri, seg = raster.bin_pairs(rect, q_tri, wp, hp)
    b = raster.closest_hit_raster(tb, cam, w, h, jitter=jit)
    assert s_tri.shape == (tb.tri_v0.shape[0] * n_tiles,)
    assert pair_tri.shape == (int(seg[-1]),)
    assert s_seg.dtype == torch.int32 and pair_tri.dtype == torch.int32
    assert torch.equal(s_seg, seg) and int(seg[-1]) > 0
    assert torch.equal(s_tri[:int(seg[-1])], pair_tri)
    assert int(a["pairs"]) == int(b["pairs"]) == int(seg[-1])
    for k in ("t", "tri", "uv", "hit", "tile_qmin"):
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("detail,tris,pairs", [(1.4, 256_798, 314_444),
                                                (1.0, 120_146, 164_199)])
def test_atrium_binning_matches_jax(detail, tris, pairs):
    """The main path's binning: the atrium (`atrium_scene(detail)`) seen by
    `bench_raster_frame`'s camera at 1920x1080, padded to 1920x1088.  At
    the bench's detail 1.4 both packages bin the same 314,444 pairs, the
    count behind the raster kernel's bound; the ~170k of the comment at
    raster_pallas.py:421 is the count of the detail-1.0 atrium."""
    jb = jbvh.build_bvh(jmesh.atrium_scene(detail), cache=False)
    assert int(np.asarray(jb.tri_valid).sum()) == tris
    cam = jcam.look_at((8.0, 6.0, -14.0), (0.0, 3.0, 0.0),
                       v_fov=math.radians(60), aspect=1920 / 1080)
    mat, attr = rp.perspective_rows(cam, 1920, 1080)
    n = _assert_same_binning(jb, convert.bvh_from_numpy(jb, "cpu"), mat,
                             attr, 1920, 1088, rp.PAIR_CAP)
    assert n == pairs


def _far_sphere():
    """A subdivided ico sphere 60 units off under a 3-degree view at 128x64:
    its 5,120 triangles are sub-pixel, and their float32 planes cover
    samples outside them (no near-plane clipping, as in JAX)."""
    jb = jbvh.build_bvh([(jmesh.ico_sphere(1.0, 4).transformed(
        translate=(0.0, 1.0, 60.0)), 0)], cache=False)
    cam = jcam.look_at((0.0, 1.0, 0.0), (0.0, 1.0, 1.0),
                       v_fov=math.radians(3), aspect=2.0)
    return jb, convert.bvh_from_numpy(jb, "cpu"), cam, 128, 64


def test_jax_bound_does_not_hold_sub_pixel_planes():
    """Why the kernel culls on its own bound and not on JAX's: on sub-pixel
    triangles the plain version's winners (which the kernel must return
    bit for bit) include pixels whose q lies above the bound of their JAX
    visit, decoded from JAX's visit words."""
    jb, tb, jc, w, h = _far_sphere()
    mat, attr = rp.perspective_rows(jc, w, h)
    mat_t, attr_t = (torch.as_tensor(np.array(x)) for x in (mat, attr))
    planes, rect, q_tri = raster.project_planes(
        tb.tri_v0, tb.tri_e1, tb.tri_e2, tb.tri_valid, mat_t, attr_t, w, h)
    pair_tri, seg = raster.bin_pairs(rect, q_tri, w, h)
    lists, visit_bounds = _jax_tile_lists(jb, mat, attr, w, h, PAIR_CAP)
    assert all(pair_tri[seg[t]:seg[t + 1]].tolist() == lst
               for t, lst in enumerate(lists))
    q, tri, _, _ = raster.rasterize_plain(planes, pair_tri, seg,
                                          torch.tensor([0.5, 0.5]), w, h)
    ntx = w // raster.TILE_X
    above = 0
    for pix in torch.nonzero(tri >= 0)[:, 0].tolist():
        y, x = divmod(pix, w)
        t = (y // raster.TILE_Y) * ntx + x // raster.TILE_X
        rank = lists[t].index(int(tri[pix]))
        above += float(q[pix]) > visit_bounds[t][rank // rp.GROUP]
    assert above > 0


def test_plain_blocks_keep_the_first_winner(monkeypatch):
    """The plain version's ranks-at-a-time steps give the kernel's walk in
    order with a strict `>`: any step size gives the same answer, and an
    exact tie (a duplicated sphere: equal plane rows) goes to the pair
    listed first in the tile."""
    meshes = _demo(tmesh)
    tb = tbvh.build_bvh(meshes + [meshes[1]], device="cpu")
    _, _, _, w, h, jit = CASES["demo"]
    cam = convert.camera_from_numpy(_camera("demo"), "cpu")
    mat, attr = raster.perspective_rows(cam, w, h)
    planes, rect, q_tri = raster.project_planes(
        tb.tri_v0, tb.tri_e1, tb.tri_e2, tb.tri_valid, mat, attr, w, h)
    pair_tri, seg = raster.bin_pairs(rect, q_tri, w, h)
    jitter = torch.tensor(jit)
    base = raster.rasterize_plain(planes, pair_tri, seg, jitter, w, h)
    monkeypatch.setattr(raster, "PLAIN_BLOCK", 3 * raster.PX * 6)
    small = raster.rasterize_plain(planes, pair_tri, seg, jitter, w, h)
    for a, b in zip(base, small):
        assert torch.equal(a, b)
    twins = {}
    for i, row in enumerate(planes.numpy()):
        if np.isfinite(row).all():
            twins.setdefault(row.tobytes(), []).append(i)
    twin_of = {i: ids for ids in twins.values() if len(ids) == 2 for i in ids}
    assert len(twin_of) >= 2 * 300            # the sphere's 320 triangles
    ntx = w // raster.TILE_X
    tri = base[1].reshape(h, w).numpy()
    checked = 0
    for y in range(0, h, 3):
        for x in range(0, w, 3):
            win = int(tri[y, x])
            if win not in twin_of:
                continue
            t = (y // raster.TILE_Y) * ntx + x // raster.TILE_X
            order = pair_tri[seg[t]:seg[t + 1]].tolist()
            assert order.index(win) == min(order.index(i) for i in twin_of[win])
            checked += 1
    assert checked > 50


def test_raster_matches_the_ray_path_on_the_port(scenes):
    """The pipeline-level parity the JAX package lacks: `closest_hit_raster`
    with a jitter against `bvh.closest_hit` over `generate_rays(offset=
    jitter)` rays.  `hit` equal off edges.  `t` within 1e-4 relative on at
    least 99% of the pixels and within 1e-3 on all: the raster's t comes
    from q in closed form, and the float32 edge planes of small or distant
    triangles come from cross products that cancel, as in JAX's own
    raster-vs-ray test (test_raster_pallas.py:53-55, 99.9th percentile
    below 1e-3)."""
    for case in ("near-plane-crossing", "jittered"):
        scene, _, _, w, h, jit = CASES[case]
        tb = scenes[scene][1]
        cam = convert.camera_from_numpy(_camera(case), "cpu")
        ras = _numpy(raster.closest_hit_raster(tb, cam, w, h, jitter=jit))
        o, d = tcam.generate_rays(cam, w, h, offset=jit)
        ray = _numpy(tbvh.closest_hit(tb, o, d))
        _, emin = _candidates(tb, case)
        differ = ras["hit"] != ray["hit"]
        assert np.all(np.abs(emin[differ]) <= EDGE), case
        both = ras["hit"] & ray["hit"]
        assert both.mean() > 0.2
        rel = np.abs(ras["t"][both] - ray["t"][both]) / ray["t"][both]
        assert (rel <= 1e-4).mean() >= 0.99 and rel.max() <= 1e-3, case


# --------------------------------------------------------------------------
# The kernel's source, compiled as host C++
# --------------------------------------------------------------------------

HARNESS = """\
#include "raster.cu"
// One one-thread block per band of a tile: that thread owns all of the
// band's pixels and stages every plane row itself.
extern "C" int host_raster(const RasterArgs* a) {
  blockDim = dim3(1);
  threadIdx = dim3(0);
  for (int b = 0; b < a->n_tiles * RASTER_BANDS; ++b) {
    blockIdx = dim3(b);
    raster_tiles<RASTER_BAND_PX>(*a);
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_raster(tmp_path_factory):
    host = build_host(tmp_path_factory, "host_raster", HARNESS,
                      ("host_raster", "raster_args_size"))
    host.host_raster.argtypes = [ctypes.c_void_p]
    return host


def _kernel_inputs(case, meshes):
    """The raster kernel's inputs for `meshes` seen by CASES[case]'s camera
    at the padded size, as `closest_hit_raster` makes them, and that
    size."""
    _, _, _, w, h, jit = CASES[case]
    tb = tbvh.build_bvh(meshes, device="cpu")
    cam = convert.camera_from_numpy(_camera(case), "cpu")
    wp, hp = w + (-w) % raster.TILE_X, h + (-h) % raster.TILE_Y
    mat, attr = raster.perspective_rows(cam, w, h)
    planes, rect, q_tri = raster.project_planes(
        tb.tri_v0, tb.tri_e1, tb.tri_e2, tb.tri_valid, mat, attr, wp, hp)
    pair_tri, seg = raster.bin_pairs(rect, q_tri, wp, hp)
    return (planes, pair_tri, seg, torch.tensor(jit)), wp, hp


def _host_run(host, args, wp, hp):
    """The kernel source through the real wrapper (`raster.launch`), with
    its work counters: (q, tri, u, v), [pairs tested, pairs culled]."""
    stats = torch.zeros(2, dtype=torch.int64)
    out = raster.launch(host.host_raster, *args, wp, hp, stats=stats)
    return out, stats.tolist()


@pytest.mark.parametrize("case", ["demo", "near-plane-crossing", "jittered"])
def test_host_kernel_matches_plain(host_raster, case):
    """Through the real wrapper (`raster.launch`): q, tri, u and v equal
    bit for bit (every operation rounded as the plain version rounds it,
    the cull never dropping a pair that could win), with a duplicated
    sphere so that exact ties occur; every pair of every band is tested or
    culled."""
    meshes = _demo(tmesh)
    args, wp, hp = _kernel_inputs(case, meshes + [meshes[1]])
    want = raster.rasterize_plain(*args, wp, hp)
    got, (tested, culled) = _host_run(host_raster, args, wp, hp)
    assert (want[1] >= 0).float().mean() > 0.2
    for name, a, b in zip(("q", "tri", "u", "v"), got, want):
        assert torch.equal(a, b), name
    assert tested + culled == raster.BANDS * int(args[2][-1])


def _occluded_scene():
    """A quad close to the demo camera, facing it and filling the left half
    of the view, in front of a grid of 64 spheres: the left tiles hold
    thousands of pairs behind a nearer surface, the right ones none."""
    spheres = [(tmesh.uv_sphere(0.35, 12, 16).transformed(
        translate=(-3.5 + i % 8, 0.2 + (i // 8) % 2, 1.0 + i // 16)), 1)
        for i in range(64)]
    wall = tmesh.quad(1.6).transformed(
        translate=(-1.6, 1.2, -4.0),
        rotate=(math.sin(-math.pi / 4), 0.0, 0.0, math.cos(-math.pi / 4)))
    return spheres + [(wall, 2)]


# Sample offsets at the pixel's edges put the band's corner samples, where
# the cull takes each plane's largest q, on the band's own border.
JITTERS = [(0.5, 0.5), (0.0, 0.0), (0.999, 0.001)]


@pytest.mark.parametrize("jitter", JITTERS)
def test_host_kernel_culls_occluded_pairs(host_raster, jitter):
    """The cull fires: behind a near quad the blocks cull pairs, and the
    output still equals the plain version's (which tests every pair) bit
    for bit."""
    args, wp, hp = _kernel_inputs("demo", _occluded_scene())
    args = args[:3] + (torch.tensor(jitter),)
    want = raster.rasterize_plain(*args, wp, hp)
    got, (tested, culled) = _host_run(host_raster, args, wp, hp)
    for name, a, b in zip(("q", "tri", "u", "v"), got, want):
        assert torch.equal(a, b), name
    assert tested + culled == raster.BANDS * int(args[2][-1])
    assert culled > 0.2 * (tested + culled)
    assert (want[1] >= 0).float().mean() > 0.3


@pytest.mark.parametrize("jitter", JITTERS)
def test_host_kernel_matches_plain_on_sub_pixel_planes(host_raster, jitter):
    """Where JAX's bound fails (the far sphere's sub-pixel triangles, see
    `test_jax_bound_does_not_hold_sub_pixel_planes`), the kernel's own
    bound holds: the plain version's bits.  (The sphere leaves background
    in every tile, so nothing is culled here: the occluded scene above
    shows the cull.)"""
    _, tb, jc, w, h = _far_sphere()
    mat, attr = raster.perspective_rows(convert.camera_from_numpy(jc, "cpu"),
                                        w, h)
    planes, rect, q_tri = raster.project_planes(
        tb.tri_v0, tb.tri_e1, tb.tri_e2, tb.tri_valid, mat, attr, w, h)
    pair_tri, seg = raster.bin_pairs(rect, q_tri, w, h)
    args = (planes, pair_tri, seg, torch.tensor(jitter))
    want = raster.rasterize_plain(*args, w, h)
    got, (tested, culled) = _host_run(host_raster, args, w, h)
    assert int((want[1] >= 0).sum()) > 1000
    for name, a, b in zip(("q", "tri", "u", "v"), got, want):
        assert torch.equal(a, b), name
    assert tested + culled == raster.BANDS * int(seg[-1])


def test_host_kernel_matches_plain_on_the_atrium(host_raster):
    """The main path's frame (`bench_raster_frame`'s atrium and camera at
    1920x1080, padded to 1920x1088), whose ~2,100 plain winners above
    JAX's bound come from sub-pixel planes: the kernel returns the plain
    version's bits and culls most of its (pair, band) work."""
    tb = tbvh.build_bvh(tmesh.atrium_scene(1.4), device="cpu")
    cam = tcam.look_at((8.0, 6.0, -14.0), (0.0, 3.0, 0.0), device="cpu",
                       v_fov=math.radians(60), aspect=1920 / 1080)
    mat, attr = raster.perspective_rows(cam, 1920, 1080)
    planes, rect, q_tri = raster.project_planes(
        tb.tri_v0, tb.tri_e1, tb.tri_e2, tb.tri_valid, mat, attr, 1920, 1088)
    pair_tri, seg = raster.bin_pairs(rect, q_tri, 1920, 1088)
    args = (planes, pair_tri, seg, torch.tensor([0.3, 0.7]))
    want = raster.rasterize_plain(*args, 1920, 1088)
    got, (tested, culled) = _host_run(host_raster, args, 1920, 1088)
    for name, a, b in zip(("q", "tri", "u", "v"), got, want):
        assert torch.equal(a, b), name
    assert tested + culled == raster.BANDS * int(seg[-1])
    assert tested < 0.3 * (tested + culled)


def test_kernel_layout_matches_the_wrapper(host_raster):
    src = (cuda_build.CSRC_DIR / "raster.cu").read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (RASTER_[A-Z_]+) = (\d+);", src)}
    assert consts["RASTER_TILE_X"] == raster.TILE_X
    assert consts["RASTER_TILE_Y"] == raster.TILE_Y
    assert consts["RASTER_PLANE_COLS"] == raster.PLANE_COLS
    assert consts["RASTER_BANDS"] == raster.BANDS
    assert host_raster.raster_args_size() == ctypes.sizeof(raster.RasterArgs)
    fields = re.search(r"struct RasterArgs \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"(\w+);", fields)
    assert names == [f for f, _ in raster.RasterArgs._fields_]
    assert "stats" in names


def test_wrapper_takes_the_plain_version_on_cpu(scenes):
    jb, tb = scenes["demo"]
    case = "demo"
    _, _, _, w, h, jit = CASES[case]
    cam = convert.camera_from_numpy(_camera(case), "cpu")
    mat, attr = raster.perspective_rows(cam, w, h)
    planes, rect, q_tri = raster.project_planes(
        tb.tri_v0, tb.tri_e1, tb.tri_e2, tb.tri_valid, mat, attr, w, 96)
    pair_tri, seg = raster.bin_pairs(rect, q_tri, w, 96)
    before = raster.rasterize_tiles.launches
    a = raster.rasterize_tiles(planes, pair_tri, seg, torch.tensor(jit), w, 96)
    b = raster.rasterize_plain(planes, pair_tri, seg, torch.tensor(jit), w, 96)
    assert raster.rasterize_tiles.launches == before
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("kw,error", [
    ({"binning": "group"}, None),
    ({"tile_qmin": torch.zeros(6)}, None),
    ({"binning": "tri", "tile_qmin": torch.zeros(6)}, None),
    ({"binning": "cluster"}, ValueError)])
def test_unported_binning_raises(scenes, kw, error):
    """JAX's `binning=` and `tile_qmin=` keywords: "tri" is the pair path;
    "group", or any `tile_qmin` (JAX's routing, raster_pallas.py:812),
    takes the group path with its occlusion feedback, whose hits equal the
    pair path's (tests/test_torch_raster_group.py holds it against JAX);
    an unknown binning raises ValueError."""
    _, tb = scenes["demo"]
    cam = convert.camera_from_numpy(_camera("demo"), "cpu")
    tri = raster.closest_hit_raster(tb, cam, 128, 96, binning="tri")
    assert tri["hit"].any() and "pairs" in tri
    if error is not None:
        with pytest.raises(error, match="binning"):
            raster.closest_hit_raster(tb, cam, 128, 96, **kw)
        return
    got = raster.closest_hit_raster(tb, cam, 128, 96, **kw)
    assert "visits" in got and int(got["overflow"]) == 0
    assert torch.equal(got["hit"], tri["hit"]) and torch.equal(got["t"],
                                                              tri["t"])
