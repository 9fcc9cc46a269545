"""The port's light probes (`render/light_probe.py`) against the JAX
package's on the CPU: `update_probes` with JAX's random rotation injected
(`jax.random.uniform(key)`), twice, so the second blends with hysteresis;
`sample_irradiance` on the result at random points and normals and on the
ground.  Irradiance and depth texels within 1e-4 of their largest value
(the BVH queries run through the plain ray version here: both packages
find the same hits), the sampled irradiance within 1e-4 of its scale."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3d12renderer_tpu.render import bvh as jbvh
from d3d12renderer_tpu.render import light_probe as jprobe
from d3d12renderer_tpu.render import mesh as jmesh
from d3d12renderer_tpu.render import pathtracer as jpt
from d3d12renderer_tpu_torch import convert
from d3d12renderer_tpu_torch.render import light_probe as tprobe
from d3d12renderer_tpu_torch.render import pathtracer as tpt

torch.set_num_threads(1)
TOL = 1e-4
GRID = dict(origin=(-5.0, 0.5, -5.0), extent=(10.0, 3.0, 10.0), dims=(4, 2, 3))


@pytest.fixture(scope="module")
def scenes():
    meshes = [(jmesh.quad(half=20.0), 0),
              (jmesh.ico_sphere(1.0, 2).transformed(translate=(0, 1.0, 0)), 1),
              (jmesh.box((0.7, 0.7, 0.7)).transformed(
                  translate=(2.2, 0.7, -0.5)), 2)]
    mats = jpt.Materials(albedo=jnp.array([[0.5, 0.5, 0.5], [0.8, 0.2, 0.2],
                                           [0.2, 0.4, 0.8]]),
                         emissive=jnp.zeros((3, 3)),
                         roughness=jnp.array([0.8, 0.3, 0.6]),
                         metallic=jnp.zeros(3))
    js = jpt.Scene(bvh=jbvh.build_bvh(meshes, cache=False), materials=mats,
                   sky=jpt.default_sky())
    ts = tpt.Scene(bvh=convert.bvh_from_numpy(js.bvh, "cpu"),
                   materials=convert.materials_from_numpy(mats, "cpu"),
                   sky=convert.sky_from_numpy(js.sky, "cpu"))
    return js, ts


@pytest.fixture(scope="module")
def grids(scenes):
    js, ts = scenes
    jg = jprobe.create_probe_grid(**GRID)
    tg = tprobe.create_probe_grid(**GRID, device="cpu")
    out = []
    for i in range(2):
        key = jax.random.PRNGKey(40 + i)
        jg = jprobe.update_probes(jg, js, key, rays_per_probe=24)
        tg = tprobe.update_probes(
            tg, ts, rotation=torch.as_tensor(np.array(jax.random.uniform(key))),
            rays_per_probe=24)
        out.append((jg, tg))
    return out


def test_grid_layout_matches_jax(scenes):
    jg = jprobe.create_probe_grid(**GRID)
    tg = tprobe.create_probe_grid(**GRID, device="cpu")
    np.testing.assert_allclose(tg.spacing.numpy(), np.asarray(jg.spacing),
                               rtol=1e-7)
    np.testing.assert_allclose(tprobe.probe_positions(tg).numpy(),
                               np.asarray(jprobe.probe_positions(jg)),
                               rtol=1e-6, atol=1e-6)
    assert tg.num_probes == jg.num_probes == 24
    assert tg.irradiance.shape == jg.irradiance.shape
    assert tg.depth.shape == jg.depth.shape


@pytest.mark.parametrize("update", [0, 1])
def test_update_probes_matches_jax(grids, update):
    jg, tg = grids[update]
    for f in ("irradiance", "depth"):
        want = np.asarray(getattr(jg, f))
        got = getattr(tg, f).numpy()
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, rtol=TOL,
                                   atol=TOL * np.abs(want).max(), err_msg=f)
    if update:     # hysteresis: the second update moved the first's texels
        assert not np.allclose(np.asarray(jg.irradiance),
                               np.asarray(grids[0][0].irradiance))


def test_update_probes_draws_from_a_generator(scenes):
    _, ts = scenes
    grid = tprobe.create_probe_grid(**GRID, device="cpu")
    a = tprobe.update_probes(grid, ts, generator=torch.Generator().manual_seed(
        3), rays_per_probe=8)
    b = tprobe.update_probes(grid, ts, generator=torch.Generator().manual_seed(
        3), rays_per_probe=8)
    c = tprobe.update_probes(grid, ts, generator=torch.Generator().manual_seed(
        4), rays_per_probe=8)
    assert torch.equal(a.irradiance, b.irradiance)
    assert not torch.equal(a.irradiance, c.irradiance)


def test_sample_irradiance_matches_jax(grids):
    """At random points and normals (probes on both sides of the sphere and
    the box) and on the ground."""
    jg, _ = grids[1]
    tg = convert.light_probe_grid_from_numpy(jg, "cpu")
    rng = np.random.default_rng(5)
    pos = rng.uniform([-6, -0.2, -6], [6, 3.8, 6], (3000, 3)).astype(
        np.float32)
    nrm = rng.normal(size=(3000, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    pos[:500, 1] = 0.0
    nrm[:500] = (0.0, 1.0, 0.0)
    want = np.asarray(jprobe.sample_irradiance(jg, jnp.asarray(pos),
                                               jnp.asarray(nrm)))
    got = tprobe.sample_irradiance(tg, torch.as_tensor(pos),
                                   torch.as_tensor(nrm)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * np.abs(want).max())
    assert want.std() > 1e-3
