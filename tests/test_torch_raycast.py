"""The port's exact ray tests and scene ray cast (physics/raycast.py)
against the JAX package on the CPU: every `ray_vs_*` on 512 seeded rays and
primitives, and `ray_cast` on examples/showcase.py's terrain drop and on a
scene of every collider type over a plane and a terrain.  Each JAX function
runs under its own jit.

Tolerances: hit masks (t < 1e30) equal; where both hit, t within 1e-4 or
1e-5 of itself (a few float32 ulps of the quadratics' roots; the longest
terrain rays of ray_cast, 42 m, differ by 1.6e-4) and normals within 1e-3
(a grazing hit's normal turns the root's rounding into up to 1.6e-4
measured, capsule sides).  The hull test sphere-traces on GJK, whose closest
point depends on the last ulp on flat features (tests/test_torch_gjk.py),
so its t and normal are compared where JAX's own answer holds still
under four ~1-ulp probes of the ray's origin, at most 2% of those rays may
differ.  The heightfield's march takes JAX's float32 `linspace` (i times
the step), so its brackets match; its bisection then follows bilinear
samples that round otherwise where XLA fuses multiply-adds (up to 2.7e-6
in height), within the same bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import ConvexHull

from d3d12renderer_tpu.physics import raycast as jray
from d3d12renderer_tpu.physics.builder import SceneBuilder as JaxSceneBuilder
from d3d12renderer_tpu.physics.types import MAX_HULL_VERTS
from d3d12renderer_tpu_torch.convert import body_state_from_numpy
from d3d12renderer_tpu_torch.models import scenes
from d3d12renderer_tpu_torch.physics import raycast
from d3d12renderer_tpu_torch.physics.builder import SceneBuilder

torch.set_num_threads(1)

N = 512
TOL = 1e-4
T_RTOL = 1e-5
N_TOL = 1e-3
BODY_FIELDS = ("pos", "rot", "vel", "omega", "force", "torque")


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _rays(rng, n=N, spread=2.0, dist=6.0):
    """Origins `dist` away around the origin aimed within `spread` of it."""
    o = _unit(rng.normal(0, 1, (n, 3))) * dist
    target = rng.uniform(-spread, spread, (n, 3)) * 0.5
    return o.astype(np.float32), _unit(target - o)


def _prims(rng, n=N):
    q = rng.normal(0, 1, (n, 4))
    return dict(pos=rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32),
                rot=_unit(q), r=rng.uniform(0.3, 1.0, n).astype(np.float32),
                h=rng.uniform(0.1, 0.8, n).astype(np.float32),
                half=rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32))


def _compare(name, got, want):
    gt, gn = (x.numpy() for x in got)
    wt, wn = (np.asarray(x) for x in want)
    hit = wt < 1e29
    np.testing.assert_array_equal(gt < 1e29, hit, err_msg=name)
    assert 0.2 < hit.mean() < 0.95, name
    np.testing.assert_allclose(gt[hit], wt[hit], rtol=T_RTOL, atol=TOL,
                               err_msg=name)
    np.testing.assert_allclose(gn[hit], wn[hit], rtol=0, atol=N_TOL,
                               err_msg=name)


def _capsule_ends(p):
    from d3d12renderer_tpu_torch.core import maths as m

    axis = m.quat_rotate(torch.as_tensor(p["rot"]),
                         torch.tensor([0.0, 1.0, 0.0]).expand(N, 3)).numpy()
    return p["pos"] - axis * p["h"][:, None], p["pos"] + axis * p["h"][:, None]


_CASES = {
    "sphere": (lambda p: (p["pos"], p["r"]), "ray_vs_sphere"),
    "capsule": (lambda p: (*_capsule_ends(p), p["r"] * 0.5), "ray_vs_capsule"),
    "box": (lambda p: (p["pos"], p["rot"], p["half"]), "ray_vs_box"),
    "cylinder": (lambda p: (p["pos"], p["rot"], p["r"], p["h"]),
                 "ray_vs_cylinder"),
    "plane": (lambda p: (_unit(p["half"] - 0.6), p["h"] - 0.4),
              "ray_vs_plane"),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_primitive_ray_tests_match_jax(case):
    make, fn = _CASES[case]
    rng = np.random.default_rng(len(case))
    o, d = _rays(rng)
    args = make(_prims(rng))
    want = jax.jit(jax.vmap(getattr(jray, fn)))(o, d, *args)
    t = torch.as_tensor
    got = getattr(raycast, fn)(t(o), t(d), *(t(a) for a in args))
    _compare(case, got, want)


def _hull_table(rng, n):
    verts = np.zeros((n, MAX_HULL_VERTS, 3), np.float32)
    mask = np.zeros((n, MAX_HULL_VERTS), bool)
    for i in range(n):
        pts = rng.normal(0, 1, (20, 3)) * rng.uniform(0.3, 0.8, 3)
        v = pts[ConvexHull(pts).vertices]
        verts[i, :len(v)] = v
        mask[i, :len(v)] = True
    return verts, mask


def test_hull_ray_test_matches_jax():
    """Conservative advancement on GJK, 128 rays at hulls; values compared
    where JAX's own t and normal hold still under four ~1-ulp probes."""
    n = 128
    rng = np.random.default_rng(21)
    o, d = _rays(rng, n)
    p = _prims(rng, n)
    hv, hm = _hull_table(rng, n)
    fn = jax.jit(jray.ray_vs_hull)     # batched over the rows already
    probes = [o, (o * (1 - 1e-7)).astype(np.float32),
              (o * (1 + 1e-7)).astype(np.float32),
              (o + np.float32(1e-7)).astype(np.float32),
              (o - np.float32(1e-7)).astype(np.float32)]
    wants = [np.concatenate([np.asarray(x).reshape(n, -1) for x in
                             fn(po, d, p["pos"], p["rot"], hv, hm)], -1)
             for po in probes]
    t = torch.as_tensor
    gt, gn = raycast.ray_vs_hull(t(o), t(d), t(p["pos"]), t(p["rot"]), t(hv),
                                 t(hm))
    got = np.concatenate([gt.numpy()[:, None], gn.numpy()], -1)
    hit = wants[0][:, 0] < 1e29
    stable = np.ones(n, bool)
    for w in wants[1:]:
        stable &= np.abs(np.minimum(w, 1e3) - np.minimum(wants[0], 1e3)
                         ).max(-1) <= 1e-5
    bad = stable & (np.abs(np.minimum(got, 1e3) - np.minimum(wants[0], 1e3))
                    .max(-1) > TOL)
    print(f"ray_vs_hull: {int(stable.sum())} of {n} rays compared "
          f"({int(hit.sum())} hits), {int(bad.sum())} differ")
    assert 0.2 < hit.mean() < 0.95
    assert stable.sum() >= n // 2
    assert bad.sum() <= 0.02 * n


def test_heightfield_ray_test_matches_jax():
    """Rays from above the showcase terrain at slants, some over its edge
    (clamped samples) and some pointing up (misses)."""
    h = scenes.terrain_drop_heights()
    o_np = np.array(scenes.TERRAIN_DROP_ORIGIN, np.float32)
    cell = np.float32(scenes.TERRAIN_DROP_CELL)
    rng = np.random.default_rng(2)
    n = 256
    o = np.stack([rng.uniform(-30, 30, n), rng.uniform(6, 20, n),
                  rng.uniform(-30, 30, n)], -1).astype(np.float32)
    d = _unit(np.stack([rng.normal(0, 0.5, n), -rng.uniform(-0.2, 1, n),
                        rng.normal(0, 0.5, n)], -1))
    want = jax.jit(jax.vmap(lambda o, d: jray.ray_vs_heightfield(
        o, d, jnp.asarray(h), jnp.asarray(o_np), cell)))(o, d)
    t = torch.as_tensor
    got = raycast.ray_vs_heightfield(t(o), t(d), t(h), t(o_np), t(cell))
    _compare("heightfield", got, want)


def _shapes_scene(b):
    """One collider of every type over the ridge terrain and a plane
    below it."""
    rng = np.random.default_rng(6)
    b.add_static_plane((0.0, 1.0, 0.0), -0.5)
    turn = (0.0, np.sin(0.4), 0.0, np.cos(0.4))
    for i, add in enumerate((
            lambda k: b.add_sphere_collider(k, 0.4),
            lambda k: b.add_capsule_collider(k, 0.25, 0.4, rotation=turn),
            lambda k: b.add_box_collider(k, (0.4, 0.3, 0.5), rotation=turn),
            lambda k: b.add_cylinder_collider(k, 0.35, 0.3, rotation=turn),
            lambda k: b.add_hull_collider(k, rng.normal(0, 0.4, (16, 3))))):
        body = b.add_body((1.5 + 1.3 * i, 3.0, 2.0 + 1.1 * i))
        add(body)
    b.add_terrain(scenes.ridge_heights(), origin=(0.0, 0.0, 0.0),
                  cell_size=1.0)


def _drop_scene(b):
    scenes.add_terrain_drop(b, _HEIGHTS)


_HEIGHTS = scenes.terrain_drop_heights()


@pytest.mark.parametrize("build", [_drop_scene, _shapes_scene],
                         ids=["drop", "shapes"])
def test_ray_cast_matches_jax(build):
    """Straight down over each body, over open terrain, outside the
    terrain onto the plane (or the sky), and at slants through the
    bodies: the nearest hit's kind, index, body, t, point and normal."""
    jb, tb = JaxSceneBuilder(), SceneBuilder()
    build(jb)
    build(tb)
    jarch, jstate = jb.finalize()
    tarch, _ = tb.finalize(device="cpu")
    pos = np.asarray(jstate.pos)
    rays = [((p[0] + 0.05, p[1] + 5.0, p[2] - 0.03), (0.0, -1.0, 0.0))
            for p in pos]
    rays += [((3.3, 10.0, 6.7), (0.0, -1.0, 0.0)),
             ((-40.0, 10.0, 3.0), (0.0, -1.0, 0.0)),
             ((0.5, 4.0, 0.5), (0.0, 1.0, 0.0))]
    rays += [(tuple(pos[i] - 3 * (pos[i + 1] - pos[i]) + [0, 0.1, 0]),
              tuple(pos[i + 1] - pos[i])) for i in range(len(pos) - 1)]
    o = np.array([r[0] for r in rays], np.float32)
    d = np.array([r[1] for r in rays], np.float32)
    cast = jax.jit(jax.vmap(lambda o, d: jray.ray_cast(jarch, jstate, o, d),
                            in_axes=(0, 0)))
    want = jax.device_get(cast(o, d))
    batch = len(rays)
    tstate = body_state_from_numpy(
        {f: np.broadcast_to(np.asarray(getattr(jstate, f)),
                            (batch,) + np.shape(getattr(jstate, f)))
         for f in BODY_FIELDS}, device="cpu")
    got = raycast.ray_cast(tarch, tstate, torch.as_tensor(o),
                           torch.as_tensor(d))
    for f in ("hit", "kind", "index", "body"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    hit = np.asarray(want.hit)
    for f, rtol, atol in (("t", T_RTOL, TOL), ("point", T_RTOL, TOL),
                          ("normal", 0, N_TOL)):
        np.testing.assert_allclose(getattr(got, f).numpy()[hit],
                                   np.asarray(getattr(want, f))[hit],
                                   rtol=rtol, atol=atol, err_msg=f)
    kinds = set(np.asarray(want.kind)[hit].tolist())
    assert {0, 2} <= kinds and not hit.all()
