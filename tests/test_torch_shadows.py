"""The port's spot and point shadow maps, their sampling, the shadow cache
and the atlas (`render/shadows.py`) against the JAX package's on the CPU.
Maps are cast through `closest_hit` (the plain ray version here): the same
texels hit and depths within 1e-5 relative except where a ray grazes an
edge; sampling on JAX's maps carried over equals JAX's except where a tap
lies within float rounding of its depth."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3d12renderer_tpu.render import bvh as jbvh
from d3d12renderer_tpu.render import mesh as jmesh
from d3d12renderer_tpu.render import shadows as jshadows
from d3d12renderer_tpu_torch import convert
from d3d12renderer_tpu_torch.render import shadows

torch.set_num_threads(1)
SPOT = dict(position=(3.0, 5.0, 3.0), direction=(-0.5, -0.85, -0.4),
            outer_cos=0.65, max_range=28.0)
POINT = dict(position=(-1.0, 1.5, 1.8), max_range=8.0)


def _meshes(mm):
    return [(mm.quad(half=20.0), 0),
            (mm.ico_sphere(1.0, 2).transformed(translate=(0, 1.0, 0)), 1),
            (mm.box((0.7, 0.7, 0.7)).transformed(translate=(2.2, 0.7, -0.5)),
             2)]


@pytest.fixture(scope="module")
def bvhs():
    jb = jbvh.build_bvh(_meshes(jmesh), cache=False)
    return jb, convert.bvh_from_numpy(jb, "cpu")


def _same_depths(got, want):
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    assert 0.1 < fin.mean() <= 1.0
    assert (np.isfinite(got) != fin).mean() < 2e-3
    both = fin & np.isfinite(got)
    rel = np.abs(got[both] - want[both]) / want[both]
    assert (rel <= 1e-5).mean() > 0.999


def _points(seed, n=4000):
    rng = np.random.default_rng(seed)
    return rng.uniform([-6, -0.2, -6], [6, 3, 6], (n, 3)).astype(np.float32)


def _same_factor(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    assert (np.abs(got - want) > 1e-6).mean() < 2e-3
    assert 0.02 < (want < 1).mean() < 0.98


def test_spot_map_and_sampling_match_jax(bvhs):
    jb, tb = bvhs
    want = jshadows.render_spot_shadow_map(jb, **SPOT, resolution=64)
    got = shadows.render_spot_shadow_map(tb, **SPOT, resolution=64)
    for f in ("position", "direction", "right", "up", "tan_half_fov",
              "max_range"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-6,
                                   atol=1e-7, err_msg=f)
    _same_depths(got.depth, want.depth)
    pts = _points(1)
    smap = convert.spot_shadow_map_from_numpy(want, "cpu")
    for pcf in (True, False):
        _same_factor(shadows.sample_spot_shadow(smap, torch.as_tensor(pts),
                                                pcf=pcf),
                     jshadows.sample_spot_shadow(want, jnp.asarray(pts),
                                                 pcf=pcf))


def test_point_map_and_sampling_match_jax(bvhs):
    jb, tb = bvhs
    want = jshadows.render_point_shadow_map(jb, **POINT, resolution=48)
    got = shadows.render_point_shadow_map(tb, **POINT, resolution=48)
    assert got.depth.shape == (2, 48, 48)
    _same_depths(got.depth, want.depth)
    pts = _points(2)
    pmap = convert.point_shadow_map_from_numpy(want, "cpu")
    for pcf in (True, False):
        _same_factor(shadows.sample_point_shadow(pmap, torch.as_tensor(pts),
                                                 pcf=pcf),
                     jshadows.sample_point_shadow(want, jnp.asarray(pts),
                                                  pcf=pcf))


def _updates(atlas, bvh, to_array, steps):
    """Run `steps` on an atlas: each (kind, id, args) an update."""
    out = []
    for kind, light_id, kw in steps:
        if kind == "sun":
            out.append(atlas.update_sun(bvh, to_array(kw["camera"]),
                                        to_array(kw["sun"]), resolution=32,
                                        scene_version=kw.get("version", 0)))
        elif kind == "spot":
            out.append(atlas.update_spot(bvh, light_id, **kw, resolution=32))
        else:
            out.append(atlas.update_point(bvh, light_id, **kw, resolution=24))
    return out


# A sequence of updates: lights held still (cache hits), moved (misses),
# a new scene version (misses), new lights (new viewports, a new shelf).
SUN = np.array([0.6, -0.8, 0.3], np.float32)
STEPS = [
    ("sun", None, dict(camera=(5.0, 3.0, 6.0), sun=SUN)),
    ("spot", 0, SPOT),
    ("point", 0, POINT),
    ("sun", None, dict(camera=(5.0, 3.0, 6.0), sun=SUN)),
    ("spot", 0, SPOT),
    ("point", 0, dict(POINT, position=(-1.0, 1.5, 2.4))),
    ("spot", 1, dict(SPOT, position=(-2.0, 4.0, 1.0))),
    ("sun", None, dict(camera=(5.0, 3.0, 6.0), sun=SUN, version=1)),
    ("point", 0, dict(POINT, position=(-1.0, 1.5, 2.4))),
    ("point", 1, POINT),
    ("spot", 1, dict(SPOT, position=(-2.0, 4.0, 1.0))),
]


def test_atlas_and_cache_match_jax(bvhs):
    """The same updates on an atlas of each package (size 160: the lights
    fill two shelves): equal viewports, cache hits and misses after every
    update, and every returned map's depths as JAX's."""
    jb, tb = bvhs
    ja = jshadows.ShadowAtlas(size=160)
    ta = shadows.ShadowAtlas(size=160, device="cpu")
    for i in range(len(STEPS)):
        want = _updates(ja, jb, jnp.asarray, STEPS[i:i + 1])[0]
        got = _updates(ta, tb, lambda x: torch.as_tensor(np.asarray(
            x, np.float32)), STEPS[i:i + 1])[0]
        assert ta.viewports == ja.viewports, i
        assert (ta.cache.hits, ta.cache.misses) == (ja.cache.hits,
                                                    ja.cache.misses), i
        _same_depths(got.depth, want.depth)
    assert ta.cache.hits >= 3 and len({y for y, _, _, _ in
                                       ta.viewports.values()}) == 2


def test_atlas_refuses_a_resized_viewport_and_a_full_atlas():
    atlas = shadows.ShadowAtlas(size=64, device="cpu")
    atlas.allocate("a", 32, 48)
    with pytest.raises(ValueError, match="size changed"):
        atlas.allocate("a", 32, 32)
    atlas.allocate("b", 32, 32)
    with pytest.raises(RuntimeError, match="full"):
        atlas.allocate("c", 48, 48)


def test_shadow_cache_invalidates():
    cache = shadows.ShadowCache()
    pos = np.array([1.0, 2.0, 3.0])
    assert cache.needs_render("a", pos) and not cache.needs_render("a", pos)
    cache.invalidate("a")
    assert cache.needs_render("a", pos)
    cache.invalidate()
    assert cache.needs_render("a", torch.as_tensor(pos, dtype=torch.float32))
    assert (cache.hits, cache.misses) == (1, 3)
