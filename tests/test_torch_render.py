"""The port's render modules against the JAX package on the CPU: meshes,
the BVH build (native and numpy) and dense tables, camera rays, skies, the
BRDF, hit attributes and the tone map.  Inputs come from numpy seeds; JAX
stays on the CPU; arrays cross as numpy."""

import math
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3d12renderer_tpu.render import bvh as jbvh
from d3d12renderer_tpu.render import camera as jcam
from d3d12renderer_tpu.render import mesh as jmesh
from d3d12renderer_tpu.render import pathtracer as jpt
from d3d12renderer_tpu_torch import convert
from d3d12renderer_tpu_torch.render import bvh as tbvh
from d3d12renderer_tpu_torch.render import camera as tcam
from d3d12renderer_tpu_torch.render import mesh as tmesh
from d3d12renderer_tpu_torch.render import pathtracer as tpt

torch.set_num_threads(1)
CPU = "cpu"

MESHES = {
    "quad": lambda mm: mm.quad(2.0),
    "box": lambda mm: mm.box((0.7, 0.4, 0.2)),
    "uv_sphere": lambda mm: mm.uv_sphere(0.5, 8, 12),
    "ico_sphere": lambda mm: mm.ico_sphere(0.8, 2),
    "cylinder": lambda mm: mm.cylinder(0.3, 0.6, 10),
    "capsule": lambda mm: mm.capsule(0.2, 0.3, 4, 8),
    "torus": lambda mm: mm.torus(0.9, 0.3, 12, 6),
    "arrow": lambda mm: mm.arrow(),
    "mace": lambda mm: mm.mace(),
    "hollow_cylinder": lambda mm: mm.hollow_cylinder(1.0, 0.6, 0.3, 12),
    "transformed": lambda mm: mm.torus(0.5, 0.1, 8, 4).transformed(
        translate=(1.0, 2.0, 3.0), rotate=(0.0, math.sin(0.3), 0.0,
                                           math.cos(0.3)), scale=1.5),
}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_generators_equal_jax(name):
    """numpy on both sides, the same code path: arrays exactly equal."""
    j, t = MESHES[name](jmesh), MESHES[name](tmesh)
    for f in ("positions", "normals", "uvs", "indices"):
        a, b = getattr(j, f), getattr(t, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("scene", ["sphere_grid", "atrium"])
def test_scene_generators_equal_jax(scene):
    if scene == "sphere_grid":
        j, t = (mm.sphere_grid_scene(4, 6, n=3) for mm in (jmesh, tmesh))
    else:
        j, t = (mm.atrium_scene(0.2) for mm in (jmesh, tmesh))
    assert len(j) == len(t)
    for (jm, jmat), (tm, tmat) in zip(j, t):
        assert jmat == tmat
        for f in ("positions", "normals", "uvs", "indices"):
            assert np.array_equal(getattr(jm, f), getattr(tm, f)), f


def test_benchmark_scene_sizes():
    """The sizes the path tracer and the ray leg run at."""
    atrium = tmesh.atrium_scene(1.4)
    assert sum(len(mm.indices) for mm, _ in atrium) == 256_798
    assert len(atrium) == 349
    assert len({mat for _, mat in atrium}) == 6
    grid = tmesh.sphere_grid_scene(16, 26)
    assert sum(len(mm.indices) for mm, _ in grid) == 53_250


def _bvh_scenes():
    rng = np.random.default_rng(0)
    spheres = [(tmesh.uv_sphere(0.5 + 0.1 * i, 16, 24).transformed(
        translate=tuple(rng.uniform(-3, 3, 3))), i) for i in range(6)]
    return {
        "single_chunk": [(tmesh.quad(5.0), 0),
                         (tmesh.ico_sphere(1.0, 2).transformed(
                             translate=(0, 1.0, 0)), 1)],
        "multi_chunk": spheres,
        "atrium_small": tmesh.atrium_scene(0.2),
    }


BVH_SCENES = _bvh_scenes()


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("scene", sorted(BVH_SCENES))
def test_build_bvh_equals_jax(scene, native, monkeypatch):
    """Nodes, miss links, soup, material and valid arrays exactly equal to
    JAX's `build_bvh` with the same builder (the native and numpy builders
    build the same tree but may order a leaf's triangles differently)."""
    if native and shutil.which("g++") is None:
        pytest.skip("the native builders need g++")
    monkeypatch.setenv("D3D12TPU_NATIVE_BVH", "1" if native else "0")
    meshes = BVH_SCENES[scene]
    want = jbvh.build_bvh(meshes, cache=False)
    got = tbvh.build_bvh(meshes, device=CPU, native=native)
    for f in tbvh.BVH_FIELDS:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a, b), f


@pytest.mark.parametrize("scene", sorted(BVH_SCENES))
def test_build_dense_matches_jax(scene):
    """rtol 1e-6, with an absolute floor of 1e-6 times the column's largest
    magnitude: XLA's CPU code contracts the cross products' and sums'
    a*b+c (FMA) and the port rounds each product, so entries that cancel
    to near zero differ in their last bits relative to the terms.  Rows of
    near-degenerate triangles (|e1 x e2| < 1e-6 |e1| |e2|, the poles of
    uv spheres and capsules) are left out: their normal is rounding noise,
    and their barycentric planes divide by its square."""
    meshes = BVH_SCENES[scene]
    jb = jbvh.build_bvh(meshes, cache=False)
    want, got = jb.dense, tbvh.build_bvh(meshes, device=CPU).dense
    e1, e2 = (np.asarray(x, np.float64) for x in (jb.tri_e1, jb.tri_e2))
    sound = (np.linalg.norm(np.cross(e1, e2), axis=-1)
             >= 1e-6 * np.linalg.norm(e1, axis=-1)
             * np.linalg.norm(e2, axis=-1))
    assert sound.mean() > 0.9
    for f in ("n", "n_off", "e1p", "e1_off", "e2p", "e2_off", "valid",
              "cluster_lo", "cluster_hi"):
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.shape == b.shape, f
        if a.dtype == bool:
            assert np.array_equal(a, b), f
            continue
        if not f.startswith("cluster"):
            a, b = a[sound], b[sound]
        finite = np.isfinite(a)
        assert np.array_equal(finite, np.isfinite(b)), f
        scale = float(np.abs(a[finite]).max())
        np.testing.assert_allclose(b[finite], a[finite], rtol=1e-6,
                                   atol=1e-6 * scale, err_msg=f)


def test_bvh_from_numpy_carries_the_jax_bvh():
    meshes = BVH_SCENES["single_chunk"]
    j = jbvh.build_bvh(meshes, cache=False)
    got = convert.bvh_from_numpy(j, device=CPU)
    own = tbvh.build_bvh(meshes, device=CPU)
    for f in tbvh.BVH_FIELDS:
        assert torch.equal(getattr(got, f), getattr(own, f)), f
    assert torch.equal(got.dense.e1p, torch.as_tensor(np.asarray(j.dense.e1p)))


def test_native_build_failure_raises(tmp_path, monkeypatch):
    from d3d12renderer_tpu_torch import cuda_build

    monkeypatch.setattr(cuda_build, "HOST_BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_host_library", None)
    monkeypatch.setattr(cuda_build, "_gxx", lambda: "false")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tbvh.build_bvh(BVH_SCENES["single_chunk"], device=CPU)


# --------------------------------------------------------------------------
# Camera
# --------------------------------------------------------------------------

CAM = dict(eye=(6.0, 3.2, 7.0), target=(0.0, 0.8, 0.0))


def _cams(aspect):
    j = jcam.look_at(**CAM, v_fov=math.radians(45), aspect=aspect)
    t = tcam.look_at(**CAM, device=CPU, v_fov=math.radians(45), aspect=aspect)
    return j, t


class _Draws:
    """A sampler that hands out given arrays in order, checking shapes."""

    def __init__(self, arrays):
        self.arrays = list(arrays)

    def uniform(self, shape):
        x = self.arrays.pop(0)
        assert tuple(x.shape) == tuple(shape)
        return torch.as_tensor(np.asarray(x, np.float32))


def test_look_at_matches_jax():
    j, t = _cams(1.5)
    np.testing.assert_array_equal(t.position.numpy(), np.asarray(j.position))
    np.testing.assert_array_equal(t.rotation.numpy(), np.asarray(j.rotation))


@pytest.mark.parametrize("mode", ["centre", "jitter", "thin_lens"])
def test_generate_rays_matches_jax(mode):
    """Jitter and thin-lens draws from a numpy seed, injected into both
    (JAX's through `jax.random.uniform`).  atol 1e-6: the rotation and the
    normalisation round alike up to the order of XLA's fused ops."""
    w, h = 12, 8
    j, t = _cams(w / h)
    rng = np.random.default_rng(3)
    draws = [rng.uniform(size=(h, w, 2)).astype(np.float32),
             rng.uniform(size=(h * w,)).astype(np.float32),
             rng.uniform(size=(h * w,)).astype(np.float32)]
    f_number = 2.0 if mode == "thin_lens" else 0.0
    if mode == "centre":
        jo, jd = jcam.generate_rays(j, w, h)
        to, td = tcam.generate_rays(t, w, h)
    else:
        queue = list(draws)
        orig = jax.random.uniform
        jax.random.uniform = lambda key, shape=(), *a, **k: jnp.asarray(
            queue.pop(0))
        try:
            jo, jd = jcam.generate_rays(j, w, h, key=jax.random.PRNGKey(0),
                                        f_number=f_number, focal_length=3.0)
        finally:
            jax.random.uniform = orig
        to, td = tcam.generate_rays(t, w, h, _Draws(draws),
                                    f_number=f_number, focal_length=3.0)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)


# --------------------------------------------------------------------------
# Sky, BRDF, hit attributes, tone map
# --------------------------------------------------------------------------

def _dirs(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _skies():
    cube = np.random.default_rng(5).uniform(0, 2, (6, 8, 8, 3)).astype(
        np.float32)
    jg = jpt.default_sky()
    return {
        "gradient": jg,
        "preetham": jpt.preetham_sky(turbidity=4.0, scale=0.05),
        "cubemap": jg.replace(cubemap=jnp.asarray(cube)),
    }


@pytest.mark.parametrize("kind", ["gradient", "preetham", "cubemap"])
def test_sky_radiance_matches_jax(kind):
    """rtol 1e-5: transcendental functions (exp, acos, tan, pow) of the two
    libraries differ in their last bits."""
    sky = _skies()[kind]
    d = _dirs(512, 1)
    d[:4] = [[0.0, 1.0, 0.0], [0.0, -1.0, 0.0], [1.0, 0.0, 0.0],
             np.asarray(sky.sun_direction)]
    want = np.asarray(jpt.sky_radiance(sky, jnp.asarray(d)))
    got = tpt.sky_radiance(convert.sky_from_numpy(sky, device=CPU),
                           torch.as_tensor(d)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _surface(n_rays, seed):
    rng = np.random.default_rng(seed)
    n = _dirs(n_rays, seed)
    v = _dirs(n_rays, seed + 1)
    v = np.where((np.sum(v * n, -1) < 0)[:, None], -v, v)
    return dict(n=n, v=v,
                albedo=rng.uniform(0, 1, (n_rays, 3)).astype(np.float32),
                rough=rng.uniform(0.05, 1, n_rays).astype(np.float32),
                metal=(rng.uniform(size=n_rays) < 0.4).astype(np.float32))


def test_eval_brdf_matches_jax():
    """rtol 1e-5, atol 1e-6 relative to the GGX peak: D grows as 1/alpha^2
    near grazing mirror directions."""
    s = _surface(1024, 7)
    l = _dirs(1024, 9)
    args = (s["n"], s["v"], l, s["albedo"], s["rough"], s["metal"])
    jf, jp = jpt.eval_brdf(*map(jnp.asarray, args))
    tf, tp = tpt.eval_brdf(*map(torch.as_tensor, args))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5,
                               atol=1e-6 * float(np.abs(jf).max()))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-6 * float(np.abs(jp).max()))


def test_sample_brdf_matches_jax():
    """The three uniforms injected into both; directions atol 1e-5; weights
    and pdfs rtol 1e-4 on >= 99% of the samples and 1e-2 on all: near its
    peak GGX's D turns one ulp of n.h into ~4 / alpha^2 ulps, and the
    1 / (4 v.h) Jacobian blows up at grazing half vectors."""
    s = _surface(1024, 11)
    rng = np.random.default_rng(12)
    u = [rng.uniform(size=1024).astype(np.float32) for _ in range(3)]
    queue = list(u)
    orig = jax.random.uniform
    jax.random.uniform = lambda key, shape=(), *a, **k: jnp.asarray(
        queue.pop(0))
    try:
        jl, jw, jp = jpt.sample_brdf(
            jax.random.PRNGKey(0), *map(jnp.asarray, (
                s["n"], s["v"], s["albedo"], s["rough"], s["metal"])))
    finally:
        jax.random.uniform = orig
    tl, tw, tp = tpt.brdf_sample(*map(torch.as_tensor, (
        *u, s["n"], s["v"], s["albedo"], s["rough"], s["metal"])))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    for got, want in ((tw.numpy(), np.asarray(jw)),
                      (tp.numpy()[:, None], np.asarray(jp)[:, None])):
        err = np.abs(got - want).max(-1)
        scale = np.abs(want).max(-1)
        assert np.mean(err <= 1e-5 + 1e-4 * scale) >= 0.99
        assert np.all(err <= 1e-5 + 1e-2 * scale)


def _materials(atlas: bool):
    rng = np.random.default_rng(4)
    m = dict(albedo=rng.uniform(0, 1, (3, 3)).astype(np.float32),
             emissive=rng.uniform(0, 2, (3, 3)).astype(np.float32),
             roughness=rng.uniform(0, 1, 3).astype(np.float32),
             metallic=np.array([0.0, 1.0, 0.0], np.float32))
    if atlas:
        m.update(texture_atlas=rng.uniform(0, 1, (2, 8, 8, 3)).astype(
            np.float32), albedo_texture=np.array([1, -1, 0], np.int32))
    return m


@pytest.mark.parametrize("atlas", [False, True], ids=["plain", "atlas"])
def test_hit_attributes_shaded_matches_jax(atlas):
    """Hits drawn over the soup (misses included); atol 1e-6 on the
    interpolated normal and uv, material values exact."""
    meshes = [(tmesh.ico_sphere(1.0, 1), 0), (tmesh.box((0.5, 0.5, 0.5)), 2),
              (tmesh.quad(3.0), 1)]
    jb = jbvh.build_bvh(meshes, cache=False)
    tb = tbvh.build_bvh(meshes, device=CPU)
    m = _materials(atlas)
    jm = jpt.Materials(**{k: jnp.asarray(v) for k, v in m.items()})
    tm = convert.materials_from_numpy(m, device=CPU)
    rng = np.random.default_rng(8)
    r = 256
    tri = rng.integers(-1, tb.tri_v0.shape[0], r).astype(np.int32)
    uv = rng.uniform(0, 0.5, (r, 2)).astype(np.float32)
    jres = {"tri": jnp.asarray(tri), "uv": jnp.asarray(uv)}
    tres = {"tri": torch.as_tensor(tri), "uv": torch.as_tensor(uv)}
    want = jbvh.hit_attributes_shaded(jb, jm, jres)
    got = tbvh.hit_attributes_shaded(tb, tm, tres,
                                     table=tbvh.build_shading_table(tb, tm))
    for name, a, b in zip(("n", "gn", "uv", "mat", "albedo", "rough",
                           "metal", "emissive"), want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6,
                                   rtol=0, err_msg=name)
    for name, a, b in zip(("n", "gn", "uv", "mat"),
                          jbvh.hit_attributes(jb, jres),
                          tbvh.hit_attributes(tb, tres)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6,
                                   rtol=0, err_msg=name)


def test_tonemap_and_srgb_match_jax():
    x = np.random.default_rng(2).uniform(0, 4, (16, 16, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tpt.tonemap_filmic(torch.as_tensor(x)).numpy(),
        np.asarray(jpt.tonemap_filmic(jnp.asarray(x))), atol=1e-6)
    a = tpt.to_srgb_u8(torch.as_tensor(x)).numpy().astype(int)
    b = np.asarray(jpt.to_srgb_u8(jnp.asarray(x))).astype(int)
    assert np.abs(a - b).max() <= 1       # a value on a rounding boundary


def test_tile_perm_matches_jax():
    for w, h in ((48, 32), (70, 45)):
        for a, b in zip(jpt._tile_perm(w, h), tpt._tile_perm(w, h)):
            assert np.array_equal(a, b)
