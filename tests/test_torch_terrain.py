"""The port's heightmaps and triangle-exact terrain collision against the
JAX package on the CPU: the lattice hash, `generate_heightmap`,
`sample_height_bilinear`, the min-max mips and the descent's tables, and
both triangle narrowphases.  Each JAX function runs under its own jit.
The terrain rows of `generate_contacts` and whole substeps are in
tests/test_torch_terrain_contacts.py.

Tolerances: the hash, the mips and the descent's tables exactly equal; the
heightmap within 1e-5 (amplitude 5; XLA on the CPU fuses the quintic fade
and the bilinear blend into multiply-adds that PyTorch rounds twice:
4.1e-6 measured) and the bilinear sample within 1e-5 in height and normal
(2.7e-6 / 1.4e-6 measured); the vertex narrowphase within 1e-5 (masks and
overflow equal); the convex narrowphase's GJK rows by
tests/test_torch_gjk.py's rule (values compared where JAX's own answer
holds still under four ~1-ulp probes of the box's pose, at most 2% of
those rows may differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3d12renderer_tpu.physics import gjk as jgjk
from d3d12renderer_tpu.physics import heightmap_collision as jhc
from d3d12renderer_tpu.terrain import heightmap as jhm
from d3d12renderer_tpu_torch.models import scenes
from d3d12renderer_tpu_torch.physics import gjk
from d3d12renderer_tpu_torch.physics import heightmap_collision as hc
from d3d12renderer_tpu_torch.physics.builder import SceneBuilder
from d3d12renderer_tpu_torch.physics.types import SHAPE_BOX
from d3d12renderer_tpu_torch.terrain import heightmap as hm

torch.set_num_threads(1)

# tests/test_torch_gjk.py's rule for GJK rows.
TOL = 1e-5
MAX_FLIP_SHARE = 0.02


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("seed", [0, 7, 107, 207, 2 ** 31 - 1])
def test_hash_is_bit_equal(seed):
    """The uint32 lattice hash, on lattice points over the whole int32
    range and on the small grid the heightmaps reach."""
    rng = np.random.default_rng(seed % 1000)
    ix = np.concatenate([rng.integers(-2 ** 31, 2 ** 31, 4096),
                         np.arange(-64, 64).repeat(8)]).astype(np.int32)
    iy = np.concatenate([rng.integers(-2 ** 31, 2 ** 31, 4096),
                         np.tile(np.arange(-4, 4), 128)]).astype(np.int32)
    want = np.asarray(jax.jit(lambda a, b: jhm._hash2(a, b, seed))(ix, iy))
    got = hm._hash2(torch.as_tensor(ix), torch.as_tensor(iy), seed).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [scenes.TERRAIN_DROP_MAP,
                                scenes.VEHICLE_TERRAIN_MAP,
                                dict(resolution=33, world_size=20.0, seed=3)],
                         ids=["showcase", "vehicle", "defaults"])
def test_generate_heightmap_matches_jax(kw):
    want = np.asarray(jhm.generate_heightmap(**kw))
    got = hm.generate_heightmap(**kw).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_sample_height_bilinear_matches_jax():
    """Inside and outside the grid (clamped at r - 1.001), axis 0 along x."""
    h = scenes.terrain_drop_heights()
    rng = np.random.default_rng(3)
    x = rng.uniform(-30, 30, 2000).astype(np.float32)
    z = rng.uniform(-30, 30, 2000).astype(np.float32)
    o, c = scenes.TERRAIN_DROP_ORIGIN, scenes.TERRAIN_DROP_CELL
    wh, wn = jax.jit(lambda x, z: jhm.sample_height_bilinear(
        jnp.asarray(h), o, c, x, z))(x, z)
    gh, gn = hm.sample_height_bilinear(torch.as_tensor(h), o, c,
                                       torch.as_tensor(x), torch.as_tensor(z))
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), rtol=0, atol=1e-5)
    np.testing.assert_allclose(gn.numpy(), np.asarray(wn), rtol=0, atol=1e-5)
    # Off a square grid, the two axes stay apart.
    hr = rng.normal(0, 1, (7, 12)).astype(np.float32)
    wh, _ = jhm.sample_height_bilinear(jnp.asarray(hr), (0.0, 0.0, 0.0), 1.0,
                                       jnp.asarray(x[:50] % 7),
                                       jnp.asarray(z[:50] % 12))
    gh, _ = hm.sample_height_bilinear(torch.as_tensor(hr), (0.0, 0.0, 0.0),
                                      1.0, torch.as_tensor(x[:50] % 7),
                                      torch.as_tensor(z[:50] % 12))
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(9, 9), (17, 13), (65, 65)])
def test_minmax_mips_equal(shape):
    h = np.random.default_rng(shape[1]).normal(0, 2, shape).astype(np.float32)
    want = jhc.build_minmax_mips(h)
    got = hc.build_minmax_mips(torch.as_tensor(h))
    assert len(got) == len(want)
    for (gl, gh), (wl, wh) in zip(got, want):
        np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
        np.testing.assert_array_equal(gh.numpy(), np.asarray(wh))
    # Several terrains at once: each its own pyramid.
    both = hc.build_minmax_mips(torch.as_tensor(np.stack([h, -h])))
    for (bl, bh), (wl, wh) in zip(both, want):
        np.testing.assert_array_equal(bl[0].numpy(), np.asarray(wl))
        np.testing.assert_array_equal(bh[1].numpy(), -np.asarray(wl))


def _terrain(rng, res=17):
    """A ridge plus noise, cell 0.5, origin (-1, 0.5, -2)."""
    i = np.arange(res, dtype=np.float32)
    ridge = 2.0 - 0.25 * np.abs(i - res // 2)
    h = (ridge[:, None] + rng.normal(0, 0.2, (res, res))).astype(np.float32)
    return h, np.array([-1.0, 0.5, -2.0], np.float32), np.float32(0.5)


def test_descent_tables_equal():
    """Cells, valid flags and overflow of the descent for AABBs from a
    fraction of a cell to most of the grid (the large ones overflow)."""
    rng = np.random.default_rng(11)
    h, origin, cell = _terrain(rng)
    levels = jhc.build_minmax_mips(h)
    n = 256
    center = np.stack([rng.uniform(-1.5, 7.5, n), rng.uniform(0.0, 4.0, n),
                       rng.uniform(-2.5, 6.5, n)], -1)
    half = rng.uniform(0.05, 1.0, (n, 3)) * rng.choice([1, 1, 1, 4], (n, 1))
    lo3 = (center - half).astype(np.float32)
    hi3 = (center + half).astype(np.float32)
    want = jax.jit(jax.vmap(lambda lo, hi: jhc._descend(
        levels, jnp.asarray(origin), jnp.asarray(cell), lo, hi)))(lo3, hi3)
    t = torch.as_tensor
    got = hc._descend(hc.build_minmax_mips(t(h)), t(origin).expand(n, 3),
                      t(cell).expand(n), t(lo3), t(hi3))
    for g, w, name in zip(got, want, ("cells", "valid", "overflow")):
        np.testing.assert_array_equal(_np(g), np.asarray(w), err_msg=name)
    assert 0 < int((_np(got[2]) > 0).sum()) < n
    assert int(_np(got[1]).sum(-1).min()) >= 0


def _boxes(rng, h, origin, cell, n, hull=False):
    """n boxes near the surface: centres over the grid's interior a little
    above or below the bilinear height, random turns, half extents 0.15-0.5
    (their AABBs span few cells: no overflow)."""
    r = h.shape[0]
    x = rng.uniform(origin[0] + 1.5, origin[0] + (r - 3) * cell, n)
    z = rng.uniform(origin[2] + 1.5, origin[2] + (r - 3) * cell, n)
    y, _ = hm.sample_height_bilinear(torch.as_tensor(h), origin, cell,
                                     torch.as_tensor(x, dtype=torch.float32),
                                     torch.as_tensor(z, dtype=torch.float32))
    half = rng.uniform(0.15, 0.5, (n, 3)).astype(np.float32)
    center = np.stack([x, y.numpy() + rng.uniform(-0.2, 0.6, n), z],
                      -1).astype(np.float32)
    q = rng.normal(0, 1, (n, 4))
    rot = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    return center, rot, half


_SIGNS = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                   for sz in (-1, 1)], np.float32)


def _verts(center, rot, half):
    """Box corners in world space (numpy float32, the port's rotation)."""
    from d3d12renderer_tpu_torch.core import maths as m

    t = torch.as_tensor
    return (t(center)[:, None] + m.quat_rotate(
        t(rot)[:, None], t(_SIGNS)[None] * t(half)[:, None])).numpy()


@jax.jit
def _jax_vertex(h, levels, origin, cell, verts, vmask):
    return jax.vmap(lambda v, vm: jhc.vertex_vs_terrain_triangles(
        h, levels, origin, cell, v, vm))(verts, vmask)


@jax.jit
def _jax_convex(h, levels, origin, cell, verts, vmask, ref):
    return jax.vmap(lambda v, vm, r: jhc.convex_vs_terrain_triangles(
        h, levels, origin, cell, v, vm, r))(verts, vmask, ref)


def _jax_narrow(h, origin, cell, center, rot, half, convex):
    args = (jnp.asarray(h), jhc.build_minmax_mips(h), jnp.asarray(origin),
            jnp.asarray(cell), _verts(center, rot, half))
    args += (np.ones(args[-1].shape[:-1], bool),)
    if not convex:
        return jax.device_get(_jax_vertex(*args))
    ref = jgjk.make_shape_ref(jnp.full((len(center),), SHAPE_BOX, jnp.int32),
                              jnp.asarray(half), jnp.asarray(center),
                              jnp.asarray(rot))
    return jax.device_get(_jax_convex(*args, ref))


def _port_narrow(h, origin, cell, center, rot, half, convex):
    t = torch.as_tensor
    n = len(center)
    verts = t(_verts(center, rot, half))
    vmask = torch.ones(verts.shape[:-1], dtype=torch.bool)
    args = (t(h), hc.build_minmax_mips(t(h)), t(origin).expand(n, 3),
            t(cell).expand(n), verts, vmask)
    if not convex:
        return hc.vertex_vs_terrain_triangles(*args)
    ref = gjk.make_shape_ref(SHAPE_BOX, t(half), t(center), t(rot))
    return hc.convex_vs_terrain_triangles(*args, ref)


def _rows(out):
    """(points, depths, mask, normal, overflow) -> (n, k) float64."""
    n = np.asarray(out[0]).shape[0]
    return np.concatenate([_np(x).reshape(n, -1).astype(np.float64)
                           for x in out], -1)


def test_vertex_vs_terrain_triangles_matches_jax():
    rng = np.random.default_rng(5)
    h, origin, cell = _terrain(rng)
    center, rot, half = _boxes(rng, h, origin, cell, 256)
    want = _jax_narrow(h, origin, cell, center, rot, half, convex=False)
    got = _port_narrow(h, origin, cell, center, rot, half, convex=False)
    np.testing.assert_array_equal(_np(got[2]), np.asarray(want[2]))
    np.testing.assert_array_equal(_np(got[4]), np.asarray(want[4]))
    assert 0.2 < np.asarray(want[2]).any(-1).mean() < 0.95
    np.testing.assert_allclose(_rows(got), _rows(want), rtol=0, atol=TOL)


def test_convex_vs_terrain_triangles_matches_jax():
    """The vertex table and GJK / EPA per candidate triangle; values
    compared on the rows where JAX's own manifold holds still under four
    ~1-ulp probes of the box's pose (tests/test_torch_gjk.py's rule)."""
    rng = np.random.default_rng(9)
    h, origin, cell = _terrain(rng)
    n = 256
    center, rot, half = _boxes(rng, h, origin, cell, n)

    def turned(sign):
        q = rot.astype(np.float64) + sign * 1e-7
        return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(
            np.float32)

    probes = [(center, rot), ((center * (1 - 1e-7)).astype(np.float32), rot),
              ((center * (1 + 1e-7)).astype(np.float32), rot),
              (center, turned(1.0)), (center, turned(-1.0))]
    wants = [_rows(_jax_narrow(h, origin, cell, c, r, half, convex=True))
             for c, r in probes]
    got = _rows(_port_narrow(h, origin, cell, center, rot, half,
                             convex=True))
    stable = np.ones(n, bool)
    for w in wants[1:]:
        stable &= np.abs(w - wants[0]).max(-1) <= 1e-6
    bad = stable & (np.abs(got - wants[0]).max(-1) > TOL)
    hits = wants[0][:, 12:16].any(-1)
    print(f"convex_vs_terrain_triangles: {int(stable.sum())} of {n} rows "
          f"compared ({int(hits.sum())} with contacts), {int(bad.sum())} "
          "differ")
    assert 0.2 < hits.mean() < 0.95
    assert stable.sum() >= n // 2
    assert bad.sum() <= MAX_FLIP_SHARE * n


def test_ridge_needs_the_convex_path():
    """tests/test_heightmap_mip.py's ridge: no box vertex lies below a
    triangle, yet the crest cuts the bottom face: the vertex path misses,
    the convex path finds an upward contact of depth ~0.05 near the
    crest."""
    h = scenes.ridge_heights()
    origin, cell = np.zeros(3, np.float32), np.float32(1.0)
    center = np.array([[4.0, 2.05, 4.0]], np.float32)
    rot = np.array([[0.0, 0.0, 0.0, 1.0]], np.float32)
    half = np.array([scenes.RIDGE_BOX_HALF], np.float32)
    pts_v, _, msk_v, _, ov_v = _port_narrow(h, origin, cell, center, rot,
                                            half, convex=False)
    assert int(ov_v[0]) == 0 and not bool(msk_v.any())
    pts, dep, msk, n, ov = _port_narrow(h, origin, cell, center, rot, half,
                                        convex=True)
    assert int(ov[0]) == 0 and bool(msk.any())
    assert 0.03 <= float(dep[msk].max()) <= 0.12
    assert float(n[0, 1]) > 0.9
    assert bool((torch.abs(pts[msk][:, 0] - 4.0) < 1.1).all())


def test_builder_refuses_bad_terrain_input():
    b = SceneBuilder()
    b.add_terrain(np.zeros((5, 5)))
    with pytest.raises(ValueError, match="resolution"):
        b.add_terrain(np.zeros((6, 5)))
    with pytest.raises(ValueError, match="2-D"):
        b.add_terrain(np.zeros(5))
    with pytest.raises(ValueError, match="terrain_collision"):
        b.finalize(device="cpu", terrain_collision="mesh")
