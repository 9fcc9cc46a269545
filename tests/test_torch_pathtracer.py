"""The path-tracing slice as a whole against the JAX package on the CPU:
JAX's `generate_rays` + `trace_sample` run eagerly (default backend) with
their `jax.random` draws recorded, and the same draws replayed into the
port's `render(spp=1)`.  Also the port's entry point at a tiny size."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3d12renderer_tpu.render import bvh as jbvh
from d3d12renderer_tpu.render import camera as jcam
from d3d12renderer_tpu.render import lights as jlights
from d3d12renderer_tpu.render import mesh as jmesh
from d3d12renderer_tpu.render import pathtracer as jpt
from d3d12renderer_tpu_torch import convert
from d3d12renderer_tpu_torch.entry import pathtrace_entry
from d3d12renderer_tpu_torch.ops import ray_trace
from d3d12renderer_tpu_torch.render import bvh as tbvh
from d3d12renderer_tpu_torch.render import lights as tlights
from d3d12renderer_tpu_torch.render import mesh as tmesh
from d3d12renderer_tpu_torch.render import pathtracer as tpt
from tests import torch_pt_cases as cases

torch.set_num_threads(1)
W, H, DEPTH = 48, 32, 3


def demo_scene(mm):
    """examples/render_scene.py's scene with ico spheres of subdivision 2
    (1,678 triangles: more than one 1024-row chunk)."""
    return [
        (mm.quad(half=30.0), 0),
        (mm.ico_sphere(1.0, 2).transformed(translate=(0, 1.0, 0)), 1),
        (mm.ico_sphere(0.8, 2).transformed(translate=(-2.2, 0.8, 0.6)), 2),
        (mm.box((0.7, 0.7, 0.7)).transformed(
            translate=(2.2, 0.7, -0.5),
            rotate=(0.0, math.sin(0.3), 0.0, math.cos(0.3))), 3),
        (mm.torus(0.9, 0.3).transformed(translate=(0.8, 0.3, 2.2)), 4),
    ]


MATERIALS = dict(
    albedo=np.array([[0.45, 0.45, 0.45], [0.75, 0.15, 0.12],
                     [0.95, 0.93, 0.88], [0.15, 0.3, 0.75], [0.2, 0.7, 0.3]],
                    np.float32),
    emissive=np.array([[0, 0, 0], [0, 0, 0], [0, 0, 0], [0.5, 0.2, 0.1],
                       [0, 0, 0]], np.float32),
    roughness=np.array([0.7, 0.35, 0.12, 0.5, 0.4], np.float32),
    metallic=np.array([0.0, 0.0, 1.0, 0.0, 0.0], np.float32))
LIGHTS = dict(positions=[[-1.0, 2.5, 2.0], [2.8, 2.0, 1.5]],
              colors=[[9000.0, 7000.0, 4000.0], [2000.0, 4000.0, 9000.0]],
              radii=[18.0, 18.0])
CAMERA = dict(eye=(6, 3.2, 7), target=(0, 0.8, 0), aspect=W / H,
              v_fov=math.radians(45))


class ReplaySampler:
    """Hands out recorded draws in order; each call must ask for the
    recorded shape, so the port draws in JAX's order and shapes."""

    def __init__(self, draws):
        self.draws = list(draws)
        self.kinds = []

    def _next(self, kind, shape):
        got_kind, x = self.draws.pop(0)
        assert got_kind == kind and tuple(x.shape) == tuple(shape), (
            kind, shape, got_kind, x.shape)
        self.kinds.append(kind)
        return torch.as_tensor(np.array(x))

    def uniform(self, shape):
        return self._next("uniform", shape)

    def normal(self, shape):
        return self._next("normal", shape)

    def randint(self, shape, high):
        return self._next("randint", shape).to(torch.int64)


@pytest.fixture(scope="module")
def jax_frame():
    """One spp=1 sample of JAX's `render`, eagerly: rays in tile order,
    the draws of `jax.random.uniform/normal/randint` recorded."""
    bvh = jbvh.build_bvh(demo_scene(jmesh), cache=False)
    mats = jpt.Materials(**{k: jnp.asarray(v) for k, v in MATERIALS.items()})
    scene = jpt.Scene(bvh=bvh, materials=mats, sky=jpt.default_sky(),
                      point_lights=jlights.make_point_lights(**LIGHTS))
    cam = jcam.look_at(**CAMERA)
    settings = jpt.PathTracerSettings(recursion_depth=DEPTH)
    draws = []
    mp = pytest.MonkeyPatch()
    for kind in ("uniform", "normal", "randint"):
        orig = getattr(jax.random, kind)

        def record(*a, _orig=orig, _kind=kind, **k):
            x = _orig(*a, **k)
            draws.append((_kind, np.asarray(x)))
            return x
        mp.setattr(jax.random, kind, record)
    try:
        k_cam, k_trace = jax.random.split(jax.random.PRNGKey(7))
        o, d = jcam.generate_rays(cam, W, H, key=k_cam)
        perm, inv = jpt._tile_perm(W, H)
        rad, rays = jpt.trace_sample(scene, settings, o[perm], d[perm],
                                     k_trace, with_stats=True)
    finally:
        mp.undo()
    img = np.asarray(rad[inv]).reshape(H, W, 3)
    return scene, cam, img, float(rays), draws


def test_slice_matches_jax(jax_frame):
    """The port's render on the CPU (plain ray version; bounce rays
    regrouped, as JAX's Pallas backend does it) with JAX's draws.  One
    flipped hit changes a whole path, so the image is compared per pixel:
    >= 99% of pixels within 1e-3 abs + 1e-3 rel, mean abs error < 1e-3;
    the useful-ray count equal."""
    scene, cam, want, want_rays, draws = jax_frame
    port_scene = tpt.Scene(
        bvh=tbvh.build_bvh(demo_scene(tmesh), device="cpu"),
        materials=convert.materials_from_numpy(MATERIALS, device="cpu"),
        sky=convert.sky_from_numpy(scene.sky, device="cpu"),
        point_lights=convert.point_lights_from_numpy(scene.point_lights,
                                                     device="cpu"),
    ).with_shading_table()
    assert port_scene.bvh.dense.n.shape[0] > ray_trace.TRI_CHUNK
    sampler = ReplaySampler(draws)
    img, rays = tpt.render(port_scene, convert.camera_from_numpy(
        cam, device="cpu"), W, H, tpt.PathTracerSettings(
            recursion_depth=DEPTH), spp=1, sampler=sampler)
    assert not sampler.draws, "the port drew fewer numbers than JAX"
    assert sampler.kinds[:3] == ["uniform", "uniform", "uniform"]
    img = img.numpy()
    assert np.isfinite(img).all() and img.mean() > 0.05
    err = np.abs(img - want)
    close = np.all(err <= 1e-3 + 1e-3 * np.abs(want), axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert err.mean() < 1e-3, err.mean()
    assert int(rays) == int(want_rays)


def test_sampler_draws_in_jax_order(jax_frame):
    """The kinds and shapes of one sample's draws: the jitter, then per
    bounce the sun cone (2 scalars), the light pick and sphere normal, the
    BRDF's three uniforms (no BRDF sample after the last bounce)."""
    *_, draws = jax_frame
    r = W * H
    bounce = [("uniform", ()), ("uniform", ()), ("randint", (r,)),
              ("normal", (r, 3))]
    brdf = [("uniform", (r,))] * 3
    want = [("uniform", (H, W, 2))] + (bounce + brdf) * DEPTH + bounce
    assert [(k, tuple(x.shape)) for k, x in draws] == want


def test_pathtrace_entry_on_cpu():
    """The entry point's frame at 8x6 on the CPU (plain ray version over
    the 256,798-triangle atrium): finite, lit, every primary ray counted."""
    fn, (scene, camera, sampler) = pathtrace_entry(device="cpu", width=8,
                                                   height=6)
    assert scene.bvh.tri_valid.sum() == 256_798
    img, rays = fn(scene, camera, sampler)
    assert img.shape == (6, 8, 3) and torch.isfinite(img).all()
    assert img.mean() > 0
    assert 48 <= int(rays) <= 48 * 2 * (DEPTH + 1)
    srgb = tpt.to_srgb_u8(img)
    assert srgb.dtype == torch.uint8 and srgb.shape == img.shape


def test_render_draws_from_a_generator():
    """Two renders from one seed are equal; another seed differs."""
    bvh = tbvh.build_bvh(demo_scene(tmesh), device="cpu")
    scene = tpt.Scene(bvh=bvh, materials=convert.materials_from_numpy(
        MATERIALS, device="cpu"), sky=tpt.default_sky(device="cpu"),
        point_lights=tlights.make_point_lights(**LIGHTS, device="cpu"))
    from d3d12renderer_tpu_torch.render.camera import look_at

    cam = look_at(**{k: v for k, v in CAMERA.items()}, device="cpu")

    def frame(seed):
        return tpt.render(scene, cam, 16, 12, tpt.PathTracerSettings(
            recursion_depth=2), spp=2, sampler=tpt.Sampler(
                torch.Generator().manual_seed(seed)))[0]
    a, b, c = frame(1), frame(1), frame(2)
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("case", cases.CASES)
def test_plain_shading_equals_the_eager_shading(case):
    """`trace_sample` on the CPU, whose shading runs the plain halves
    (`shade_hit_plain` / `shade_next_plain`) with the bounce's draws taken
    first, against the eager shading it was factored from (tests/torch_pt_cases.py), from one seed:
    the same draws (kinds and shapes, in order), the same radiance bit for
    bit and the same rays traced.  Cases: each sky, a texture atlas, point
    lights (one invalid), MIS off, direct lighting off, depth 4 with the
    roulette."""
    scene = cases.case_scene(case, "cpu")
    settings = cases.case_settings(case)
    o, d = cases.case_rays("cpu")
    runs = []
    for fn in (tpt.trace_sample, cases.eager_trace_sample):
        rec = cases.RecordingSampler(tpt.Sampler(
            torch.Generator().manual_seed(9)))
        rad, rays = fn(scene, settings, o, d, rec)
        runs.append((rad, int(rays), rec.calls))
    (rad, rays, calls), (want, want_rays, want_calls) = runs
    assert calls == want_calls
    assert torch.equal(rad, want) and rays == want_rays
    assert torch.isfinite(rad).all() and rad.mean() > 0
    kinds = {k for k, _ in calls}
    assert ("randint" in kinds) == (case in ("point_lights", "mis_off"))
    roulette = [c for c in calls if c == ("uniform", (o.shape[0],))]
    assert len(roulette) == 3 * settings.recursion_depth + (
        case == "roulette")


def test_shade_counters_on_the_cpu():
    """`pt.bounces` counts every bounce shaded and `pt.shade_fused` the
    bounces the kernels shaded: none on the CPU, where it is never
    recorded."""
    from d3d12renderer_tpu_torch.core import profiling

    scene = cases.case_scene("gradient", "cpu")
    o, d = cases.case_rays("cpu")
    profiling.set_enabled(True)
    try:
        profiling.resolve_frame()
        tpt.trace_sample(scene, tpt.PathTracerSettings(), o, d, tpt.Sampler(
            torch.Generator().manual_seed(1)))
        stats = profiling.resolve_frame()["stats"]
    finally:
        profiling.set_enabled(False)
    assert stats["pt.bounces"] == 4 and "pt.shade_fused" not in stats
    assert stats["pt.rows"] == 3 * o.shape[0]
