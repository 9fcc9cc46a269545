"""The port's ray queries against the JAX package's Pallas ray kernels (run
in interpret mode on the CPU, as tests/test_pallas_kernels.py runs them),
and the CUDA ray kernels' source compiled as host C++ against the plain
version.  Rays and t_max come from numpy seeds."""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3d12renderer_tpu.ops import ray_trace_pallas as jrt
from d3d12renderer_tpu.render import bvh as jbvh
from d3d12renderer_tpu_torch import cuda_build
from d3d12renderer_tpu_torch.ops import ray_trace
from d3d12renderer_tpu_torch.render import bvh as tbvh
from d3d12renderer_tpu_torch.render import mesh as tmesh

from tests.torch_host_build import build_host

torch.set_num_threads(1)
R = 1024
# `tri` is compared only where no other accepted row lies within this
# relative distance in t: JAX's packed-key winner selection
# (ray_trace_pallas.py:72-81) takes the lower column among ts within
# ~1.2e-4 relative, the port the lower row among equal ts.
TIE_REL = 2e-4


def _scene(name):
    if name == "single":
        return [(tmesh.quad(5.0), 0),
                (tmesh.ico_sphere(1.0, 2).transformed(translate=(0, 1.0, 0)),
                 1)]
    rng = np.random.default_rng(0)
    return [(tmesh.uv_sphere(0.5 + 0.1 * i, 16, 24).transformed(
        translate=tuple(rng.uniform(-3, 3, 3))), i) for i in range(6)]


def _rays(seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4, 4, (R, 3)).astype(np.float32)
    # Toward points inside the scenes' bounds, so that most rays hit.
    d = (rng.uniform(-3, 3, (R, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tm = rng.uniform(0.5, 8.0, R).astype(np.float32)
    tm[::17] = 0.0                                   # dead rows
    return o, d, tm


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name in ("single", "multi"):
        meshes = _scene(name)
        out[name] = (jbvh.build_bvh(meshes, cache=False),
                     tbvh.build_bvh(meshes, device="cpu"))
    assert out["single"][1].dense.n.shape[0] <= ray_trace.TRI_CHUNK
    assert out["multi"][1].dense.n.shape[0] > ray_trace.TRI_CHUNK
    return out


CASES = {
    # id: (scene, mode, per-ray t_max, regroup)
    "single-closest": ("single", "closest", False, False),
    "single-any-tmax": ("single", "any", True, False),
    "multi-closest": ("multi", "closest", False, False),
    "multi-closest-tmax-regroup": ("multi", "closest", True, True),
    "multi-any-tmax-regroup": ("multi", "any", True, True),
}


def _jax_query(jb, o, d, tm, mode, regroup):
    """JAX's Pallas backend (bvh.py:536-540, :620-629), interpret mode."""
    dense = jb.dense
    o, d, tmj = jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm)
    if dense.n.shape[0] > jrt.TRI_CHUNK:
        res = jrt.closest_hit_pallas_culled(dense, o, d, t_max=tmj,
                                            interpret=True, regroup=regroup,
                                            any_hit=mode == "any")
        return {k: np.asarray(v) for k, v in res.items()}
    res = {k: np.asarray(v) for k, v in jrt.closest_hit_pallas(
        dense, o, d, t_max=tmj, interpret=True).items()}
    if mode == "any":
        res["hit"] = res["hit"] & (res["t"] < np.broadcast_to(tm, (R,)))
    return res


def _accepted_t(planes, o, d, t_max):
    """(R, T) float64 t of every row the plane test accepts (inf elsewhere),
    for the tie margins."""
    p = planes.double()
    o, d = (torch.as_tensor(np.array(x)).double() for x in (o, d))
    t_max = torch.as_tensor(np.array(t_max)).double()
    t = (p[:, 3] - o @ p[:, 0:3].T) / (d @ p[:, 0:3].T)
    u = o @ p[:, 4:7].T + p[:, 7] + t * (d @ p[:, 4:7].T)
    v = o @ p[:, 8:11].T + p[:, 11] + t * (d @ p[:, 8:11].T)
    ok = ((u >= 0) & (v >= 0) & (u + v <= 1) & (t >= 1e-4)
          & (t < t_max[:, None]))
    return torch.where(ok, t, torch.inf).numpy()


def _untied(acc):
    """Rays whose nearest accepted t is unique within TIE_REL."""
    two = np.sort(acc, axis=1)[:, :2]
    with np.errstate(invalid="ignore"):           # inf - inf on misses
        return ~(two[:, 1] - two[:, 0] <= TIE_REL * np.abs(two[:, 0]))


@pytest.fixture(scope="module")
def jax_results(scenes):
    cache = {}

    def get(case):
        if case not in cache:
            scene, mode, per_ray, regroup = CASES[case]
            o, d, tm = _rays(1 if scene == "single" else 2)
            tm = tm if per_ray else np.float32(1e30)
            cache[case] = _jax_query(scenes[scene][0], o, d, tm, mode, regroup)
        return cache[case]
    return get


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_matches_jax_pallas(case, scenes, jax_results):
    """`hit` equal; closest mode: `t` rtol 1e-5 + atol 1e-6 (the port
    rounds each product of the plane test, the MXU dot accumulates in its
    own order, and n_off - o.n cancels for origins near the plane, leaving
    an error of an ulp of |o| ~ 5e-7) and `tri` equal where the nearest t is not tied within TIE_REL;
    `uv` atol 1e-4 at the untied hits (recomputed from the hit point on
    both sides)."""
    scene, mode, per_ray, regroup = CASES[case]
    o, d, tm = _rays(1 if scene == "single" else 2)
    tm = tm if per_ray else np.float32(1e30)
    want = jax_results(case)
    tb = scenes[scene][1]
    to, td = torch.as_tensor(o), torch.as_tensor(d)
    before = (ray_trace.ray_closest_hit_bvh.launches,
              ray_trace.ray_closest_hit_brute.launches)
    if mode == "any":
        hit = tbvh.any_hit(tb, to, td, torch.as_tensor(tm), regroup=regroup)
        np.testing.assert_array_equal(hit.numpy(), want["hit"])
        assert 0.1 < want["hit"].mean() < 0.9
        return
    got = tbvh.closest_hit(tb, to, td, t_max=torch.as_tensor(tm),
                           regroup=regroup)
    assert (ray_trace.ray_closest_hit_bvh.launches,
            ray_trace.ray_closest_hit_brute.launches) == before
    hit = want["hit"]
    np.testing.assert_array_equal(got["hit"].numpy(), hit)
    assert hit.sum() > 100, "degenerate test: almost no hits"
    np.testing.assert_allclose(got["t"].numpy()[hit], want["t"][hit],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got["t"].numpy()[~hit],
                                  np.broadcast_to(tm, (R,))[~hit])
    assert np.all(got["tri"].numpy()[~hit] == -1)
    planes, _ = ray_trace.kernel_tables(tb)
    untied = hit & _untied(_accepted_t(planes, o, d,
                                       np.broadcast_to(tm, (R,))))
    assert untied.sum() > 0.9 * hit.sum()
    np.testing.assert_array_equal(got["tri"].numpy()[untied],
                                  want["tri"][untied])
    np.testing.assert_allclose(got["uv"].numpy()[untied], want["uv"][untied],
                               atol=1e-4)


def test_regroup_perm_matches_jax(scenes):
    o, d, _ = _rays(3)
    dense = scenes["multi"][0].dense
    lo, hi = dense.cluster_lo.min(axis=0), dense.cluster_hi.max(axis=0)
    want = np.asarray(jrt.regroup_perm(jnp.asarray(o), jnp.asarray(d), lo, hi))
    got = ray_trace.regroup_perm(torch.as_tensor(o), torch.as_tensor(d),
                                 torch.as_tensor(np.asarray(lo)),
                                 torch.as_tensor(np.asarray(hi)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_regroup_perm_keeps_ties_in_order(scenes):
    """4096 rays from two origins (one outside the bounds) into few
    direction cells: most keys are tied, and the stable sort must keep
    JAX's order among them."""
    rng = np.random.default_rng(9)
    o = np.repeat(np.array([[0.1, 0.2, 0.3], [9.0, -9.0, 0.0]], np.float32),
                  2048, axis=0)
    d = rng.choice([-1.0, -0.3, 0.3, 1.0], (4096, 3)).astype(np.float32)
    dense = scenes["multi"][0].dense
    lo, hi = dense.cluster_lo.min(axis=0), dense.cluster_hi.max(axis=0)
    want = np.asarray(jrt.regroup_perm(jnp.asarray(o), jnp.asarray(d), lo, hi))
    got = ray_trace.regroup_perm(torch.as_tensor(o), torch.as_tensor(d),
                                 torch.tensor(np.asarray(lo)),
                                 torch.tensor(np.asarray(hi)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_regroup_is_an_exact_permutation(scenes):
    tb = scenes["multi"][1]
    o, d, tm = (torch.as_tensor(x) for x in _rays(4))
    base = tbvh.closest_hit(tb, o, d, t_max=tm)
    rg = tbvh.closest_hit(tb, o, d, t_max=tm, regroup=True)
    for k in ("t", "tri", "hit", "uv"):
        assert torch.equal(base[k], rg[k]), k


def test_node_table_links_and_padding(scenes):
    tb = scenes["multi"][1]
    nodes = ray_trace.node_table(tb)
    links = nodes[:, 6:8].contiguous().view(torch.int32)
    count = tb.node_count
    leaf = count > 0
    assert torch.equal(links[leaf, 0], tb.node_first[leaf])
    assert torch.equal(links[leaf, 1], count[leaf])
    inner = torch.nonzero(~leaf)[:, 0]
    assert torch.equal(links[inner, 0], tb.node_miss[inner + 1])
    assert torch.all(links[inner, 1] == 0)
    assert torch.all(nodes[:, 0:3] < tb.node_min)
    assert torch.all(nodes[:, 3:6] > tb.node_max)


@pytest.mark.parametrize("scene", ["single", "multi"])
def test_node_table_reaches_every_leaf_row(scenes, scene):
    """From the root, the walk's links (left child i + 1, right child the
    link of an inner row) reach every node once and every leaf's rows once:
    the leaves cover the soup's triangles exactly, not the padding."""
    tb = scenes[scene][1]
    nodes = ray_trace.node_table(tb)
    link, count = nodes[:, 6:8].contiguous().view(torch.int32).T.tolist()
    seen, rows, todo = set(), [], [0]
    while todo:
        i = todo.pop()
        assert i not in seen
        seen.add(i)
        if count[i] > 0:
            rows += range(link[i], link[i] + count[i])
        else:
            todo += [i + 1, link[i]]
    assert seen == set(range(nodes.shape[0]))
    assert sorted(rows) == list(range(int(tb.tri_valid.sum())))


# --------------------------------------------------------------------------
# The kernels' source, compiled as host C++
# --------------------------------------------------------------------------

_HARNESS = """\
#include "ray_trace.cu"
// The BVH kernel once per ray index, as one-thread blocks.
extern "C" int host_ray_bvh(const RayArgs* a) {
  if (a->stack_limit < 1 || a->stack_limit > RAY_MAX_STACK) return -1;
  blockDim = dim3(1);
  threadIdx = dim3(0);
  gridDim = dim3(1);
  for (int r = 0; r < a->num_rays; ++r) {
    blockIdx = dim3(r);
    ray_closest_hit_bvh(*a);
  }
  return 0;
}
// The brute-force kernel as one-thread blocks, one per ray.
extern "C" int host_ray_brute(const RayArgs* a) {
  if (a->stack_limit < 1 || a->stack_limit > RAY_MAX_STACK) return -1;
  host_dynamic_shared.assign(ray_brute_shared_bytes(a->num_tris) / 4, 0.0f);
  blockDim = dim3(1);
  threadIdx = dim3(0);
  gridDim = dim3(a->num_rays);
  for (int r = 0; r < a->num_rays; ++r) {
    blockIdx = dim3(r);
    ray_closest_hit_brute(*a);
  }
  return 0;
}
// The brute-force kernel's rows for a block whose rays start at different
// points (brute_rows<false> over the whole staged table), which one-thread
// blocks never reach; each ray set up as the kernel sets it up.
extern "C" int host_ray_brute_distinct(const RayArgs* a) {
  if (a->num_tris > RAY_BRUTE_CHUNK) return -1;
  host_dynamic_shared.assign(ray_brute_shared_bytes(a->num_tris) / 4, 0.0f);
  float4* rows = reinterpret_cast<float4*>(host_dynamic_shared.data());
  blockDim = dim3(1);
  threadIdx = dim3(0);
  blockIdx = dim3(0);
  stage_rows(*a, rows, 0, a->num_tris);
  for (int r = 0; r < a->num_rays; ++r) {
    const Ray ray = load_ray(*a, r);
    float t_best = a->t_max[r];
    int tri_best = -1;
    brute_rows<false>(rows, rows, 0, a->num_tris, ray, a->any_hit != 0, t_best, tri_best,
                      !(t_best >= 1e-4f));
    a->t_out[r] = t_best;
    a->tri_out[r] = tri_best;
  }
  return 0;
}
// On pairs given by (num, dn, t_best): the brute force's folded win test
// and ray_plane_test with ray_better, for a ray from the origin along +x
// against a row (dn, 0, 0 | num) whose u and v are 0.25 wherever t is
// finite, as a later row than tri_best.
extern "C" void host_wins(const float* num, const float* dn, const float* t_best, int n,
                          int* wins, int* accepted_better) {
  const Ray ray = {0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f};
  const float4 pu = {0.0f, 0.0f, 0.0f, 0.25f};
  for (int i = 0; i < n; ++i) {
    const float4 pn = {dn[i], 0.0f, 0.0f, num[i]};
    const float row_num = rn_sub(pn.w, ray_dot(0.0f, 0.0f, 0.0f, pn.x, pn.y, pn.z));
    const float row_dn = ray_dot(1.0f, 0.0f, 0.0f, pn.x, pn.y, pn.z);
    float t, t_ref;
    wins[i] = ray_plane_wins(ray, pu, pu, 0.25f, 0.25f, row_num, row_dn, t_best[i], t);
    accepted_better[i] = ray_plane_test(ray, pn, pu, pu, t_best[i], t_ref) &&
                         ray_better(t_ref, 1, t_best[i], 0);
  }
}
"""


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """csrc/ray_trace.cu built as host C++ (tests/torch_host_build.py)."""
    host = build_host(tmp_path_factory, "host_ray", _HARNESS,
                      ("host_ray_bvh", "host_ray_brute",
                       "host_ray_brute_distinct", "ray_args_size",
                       "ray_max_stack"))
    for fn in (host.host_ray_bvh, host.host_ray_brute,
               host.host_ray_brute_distinct):
        fn.argtypes = [ctypes.c_void_p]
    host.host_wins.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    host.host_wins.restype = None
    return host


def _host_query(host, kernel, tb, o, d, tm, any_hit, stack_limit=64):
    planes, nodes = ray_trace.kernel_tables(tb)
    fn = host.host_ray_bvh if kernel == "bvh" else host.host_ray_brute
    return ray_trace.launch(fn, planes,
                            nodes if kernel == "bvh" else None,
                            o, d, tm, any_hit, stack_limit)


def _assert_matches_plain(planes, o, d, tm, t, tri, any_hit):
    """Closest mode: `t` and `tri` equal to the plain version's bit for
    bit; any-hit mode: `hit` equal and each reported hit a real one."""
    want_t, want_tri = ray_trace.closest_hit_plain(planes, o, d, tm)
    assert (want_tri >= 0).sum() > 100
    if not any_hit:
        assert torch.equal(tri, want_tri)
        assert torch.equal(t, want_t)
        return
    assert torch.equal(tri >= 0, want_tri >= 0)
    acc = _accepted_t(planes, o.numpy(), d.numpy(), tm.numpy())
    hit = (tri >= 0).numpy()
    rows = tri.numpy()[hit]
    assert np.all(np.isfinite(acc[np.nonzero(hit)[0], rows]))


@pytest.mark.parametrize("mode", ["closest", "any"])
@pytest.mark.parametrize("kernel,scene", [("bvh", "multi"),
                                          ("bvh", "single"),
                                          ("brute", "multi"),
                                          ("brute", "single")])
def test_host_kernel_matches_plain(host_kernels, scenes, kernel, scene, mode):
    """Through the real wrapper (`ray_trace.launch`).  The kernels round
    every operation of the plane test as the plain version does, in the
    same order, and the BVH walk reaches every row the brute force accepts
    (padded boxes), so `t` and `tri` are equal bit for bit in closest mode; in
    any-hit mode `hit` is equal and each reported hit is a real one."""
    tb = scenes[scene][1]
    o, d, tm = (torch.as_tensor(x) for x in _rays(5))
    tm[1::5] = 1e30
    planes, _ = ray_trace.kernel_tables(tb)
    t, tri = _host_query(host_kernels, kernel, tb, o, d, tm, mode == "any")
    _assert_matches_plain(planes, o, d, tm, t, tri, mode == "any")


@pytest.mark.parametrize("t_max", ["finite", "1e30"])
@pytest.mark.parametrize("mode", ["closest", "any"])
@pytest.mark.parametrize("scene", ["single", "multi"])
def test_host_brute_kernel_matches_plain_on_1000_rays(host_kernels, scenes,
                                                     scene, mode, t_max):
    """The brute-force kernel on 1000 rays (not a multiple of its
    256-thread block), with the whole table staged (single) or chunk by
    chunk (multi), t_max per ray (dead rows included) or 1e30 everywhere."""
    tb = scenes[scene][1]
    o, d, tm = (torch.as_tensor(x[:1000]).contiguous() for x in _rays(9))
    if t_max == "1e30":
        tm.fill_(1e30)
    planes, _ = ray_trace.kernel_tables(tb)
    t, tri = _host_query(host_kernels, "brute", tb, o, d, tm, mode == "any")
    _assert_matches_plain(planes, o, d, tm, t, tri, mode == "any")


@pytest.mark.parametrize("mode", ["closest", "any"])
def test_host_brute_rows_of_distinct_origins_match_plain(host_kernels, scenes,
                                                         mode):
    """The brute force's path for blocks whose rays do not share one origin
    (every bounce wavefront's on the card; one-thread blocks always share
    theirs), over the single scene's whole table, t_max per ray (dead rows
    included) or 1e30."""
    tb = scenes["single"][1]
    o, d, tm = (torch.as_tensor(x) for x in _rays(11))
    tm[1::3] = 1e30
    planes, _ = ray_trace.kernel_tables(tb)
    t, tri = ray_trace.launch(host_kernels.host_ray_brute_distinct, planes,
                              None, o, d, tm, mode == "any", 64)
    _assert_matches_plain(planes, o, d, tm, t, tri, mode == "any")


def _edge_pairs(seed, n=4096):
    """(num, dn, t_best) float32 pairs at the edges of the win test: t
    within a few ulps of t_best and of 1e-4, num or dn zero, subnormal or
    tiny, t_best 1e30 or inf, NaN and inf terms, and random pairs."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    t_best = np.exp(rng.uniform(np.log(1e-4), np.log(1e3), n)).astype(f32)
    t_best[::7] = f32(1e30)
    t_best[3::29] = f32(1e-4)
    t_best[5::31] = np.inf
    dn = (np.exp(rng.uniform(np.log(1e-44), np.log(1e3), n))
          * rng.choice([-1, 1], n)).astype(f32)
    dn[::13] = rng.choice([0.0, -0.0, 1e-45, -1e-45, 1e-38], n)[::13]
    # t aimed at t_best (or at 1e-4), then moved a few ulps either way.
    target = np.where(rng.random(n) < 0.3, f32(1e-4), t_best).astype(f32)
    with np.errstate(all="ignore"):                  # inf * 0
        num = (target.astype(np.float64) * dn).astype(f32)
    steps = rng.integers(-4, 5, n)
    for i in range(n):
        for _ in range(abs(steps[i])):
            num[i] = np.nextafter(num[i], f32(np.inf) if steps[i] > 0
                                  else f32(-np.inf))
    wild = rng.random(n) < 0.15
    num[wild] = (rng.standard_normal(wild.sum()) * 10).astype(f32)
    num[11::37] = rng.choice([0.0, -0.0, 1e-45, -1e-45], n)[11::37]
    num[17::41] = np.nan
    dn[19::43] = np.nan
    num[23::47] = np.inf
    return num, dn, t_best


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_brute_win_test_matches_accept_and_ray_better(host_kernels, seed):
    """`ray_plane_wins` folds the accept term t_best - t >= 0 and
    `ray_better` into t < t_best (ray_plane.cuh): on pairs whose t lies
    within a few ulps of t_best, ties included, it wins exactly where the
    plane test accepts and `ray_better` prefers the later row."""
    num, dn, t_best = _edge_pairs(seed)
    n = num.shape[0]
    wins = np.zeros(n, np.int32)
    ref = np.zeros(n, np.int32)
    host_kernels.host_wins(num.ctypes.data, dn.ctypes.data,
                           t_best.ctypes.data, n, wins.ctypes.data,
                           ref.ctypes.data)
    np.testing.assert_array_equal(wins, ref)
    with np.errstate(all="ignore"):
        t = num / dn
    assert 0.1 * n < wins.sum() < 0.9 * n
    assert np.sum(t == t_best) > 0.01 * n               # ties, which lose


def test_host_kernels_count_their_work(host_kernels, scenes):
    """The work counters the bounds in chip_smoke.py read: the brute force
    tests every row for every live ray; the walk tests a few leaves' rows
    and boxes per ray; the counts add up over launches."""
    tb = scenes["multi"][1]
    o, d, tm = (torch.as_tensor(x) for x in _rays(8))
    rows = tb.dense.n.shape[0]
    live = int((tm >= 1e-4).sum())
    planes, nodes = ray_trace.kernel_tables(tb)
    stats = torch.zeros(2, dtype=torch.int64)
    ray_trace.launch(host_kernels.host_ray_brute, planes, None, o, d, tm,
                     False, stats=stats)
    assert stats.tolist() == [live * rows, 0]
    stats.zero_()
    for _ in range(2):
        ray_trace.launch(host_kernels.host_ray_bvh, planes, nodes, o, d, tm,
                         False, stats=stats)
    tests, boxes = stats.tolist()
    assert tests % 2 == 0 and boxes % 2 == 0
    assert 0 < tests < 0.1 * live * rows * 2
    assert boxes >= 2 * live


def test_host_bvh_kernel_stack_overflow_raises(host_kernels, scenes):
    """A one-entry stack cannot hold the walk: the kernel flags it and the
    wrapper raises instead of returning a partial answer."""
    tb = scenes["multi"][1]
    o, d, tm = (torch.as_tensor(x) for x in _rays(6))
    with pytest.raises(RuntimeError, match="overflowed"):
        _host_query(host_kernels, "bvh", tb, o, d, tm.fill_(1e30), False,
                    stack_limit=1)
    with pytest.raises(RuntimeError, match="launch failed"):
        _host_query(host_kernels, "bvh", tb, o, d, tm, False, stack_limit=65)


def test_host_bvh_kernel_defers_its_error_word(host_kernels, scenes):
    """With a caller's error word (as the path tracer passes one per
    sample) the launch returns without reading it; the overflow bit stays
    set across later clean launches and `raise_on_error` raises on it."""
    tb = scenes["multi"][1]
    o, d, tm = (torch.as_tensor(x) for x in _rays(6))
    tm.fill_(1e30)
    planes, nodes = ray_trace.kernel_tables(tb)
    error = ray_trace.new_error_word("cpu")
    ray_trace.launch(host_kernels.host_ray_bvh, planes, nodes, o, d, tm,
                     False, stack_limit=64, error=error)
    ray_trace.raise_on_error(error)
    ray_trace.launch(host_kernels.host_ray_bvh, planes, nodes, o, d, tm,
                     False, stack_limit=1, error=error)
    ray_trace.launch(host_kernels.host_ray_bvh, planes, nodes, o, d, tm,
                     False, stack_limit=64, error=error)
    assert int(error) & ray_trace.ERR_STACK
    with pytest.raises(RuntimeError, match="overflowed"):
        ray_trace.raise_on_error(error)


def test_kernel_layout_matches_the_wrapper(host_kernels):
    src = (cuda_build.CSRC_DIR / "ray_plane.cuh").read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (RAY_[A-Z_]+) = (\d+);", src)}
    assert consts["RAY_PLANE_COLS"] == ray_trace.PLANE_COLS
    assert consts["RAY_NODE_COLS"] == ray_trace.NODE_COLS
    assert consts["RAY_MAX_STACK"] == ray_trace.MAX_STACK
    assert consts["RAY_ERR_STACK"] == ray_trace.ERR_STACK
    assert consts["RAY_BRUTE_CHUNK"] == ray_trace.TRI_CHUNK
    assert host_kernels.ray_max_stack() == ray_trace.MAX_STACK
    assert host_kernels.ray_args_size() == ctypes.sizeof(ray_trace.RayArgs)
    fields = re.search(r"struct RayArgs \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"(\w+);", fields)
    assert names == [f for f, _ in ray_trace.RayArgs._fields_]


def test_wrappers_take_the_plain_version_on_cpu(scenes):
    tb = scenes["multi"][1]
    planes, nodes = ray_trace.kernel_tables(tb)
    o, d, tm = (torch.as_tensor(x) for x in _rays(7))
    before = (ray_trace.ray_closest_hit_bvh.launches,
              ray_trace.ray_closest_hit_brute.launches)
    a = ray_trace.ray_closest_hit_bvh(planes, nodes, o, d, tm)
    b = ray_trace.ray_closest_hit_brute(planes, o, d, tm)
    c = ray_trace.closest_hit_plain(planes, o, d, tm)
    assert (ray_trace.ray_closest_hit_bvh.launches,
            ray_trace.ray_closest_hit_brute.launches) == before
    for x, y in zip(a + b, c + c):
        assert torch.equal(x, y)
