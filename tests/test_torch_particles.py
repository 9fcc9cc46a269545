"""The port's particles (`particles/particles.py`, `particles/systems.py`)
and bitonic sort (`render/sort.py`) against the JAX package on the CPU:
each system stepped 10 times from one pool state (JAX's pool after a few
steps, carried over through `convert.particle_pool_from_numpy`) with JAX's
emission draws injected, within 1e-5; the bitonic network bit-equal,
ties and +inf sentinels included; the additive particle splat of
examples/showcase.py."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3d12renderer_tpu.particles import systems as jsys
from d3d12renderer_tpu.render import camera as jcam
from d3d12renderer_tpu.render import sort as jsort
from d3d12renderer_tpu_torch import convert
from d3d12renderer_tpu_torch.particles import systems as tsys
from d3d12renderer_tpu_torch.render import sort as tsort

import torch_world_draws as draws

STATE_TOL = 1e-5
WARM_STEPS, STEPS = 4, 10
DT = 1.0 / 60.0
SYSTEMS = {
    "fire": dict(origin=(-2.0, 0.5, -2.0), capacity=96, emit_rate=120.0),
    "smoke": dict(origin=(0.0, 0.2, 0.0), capacity=96, emit_rate=600.0),
    "debris": dict(origin=(0.0, 1.0, 0.0), capacity=96, emit_rate=300.0),
    "boids": dict(center=(0.0, 5.0, 0.0), capacity=64, emit_rate=300.0),
}


def _make(pkg, name):
    return getattr(pkg, f"make_{'boid' if name == 'boids' else name}_system")(
        **SYSTEMS[name])


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_system_steps_match_jax(name):
    """JAX's pool after WARM_STEPS steps carried over, then STEPS steps on
    both sides with the same emission draws: alive and emit_carry equal,
    every float field within STATE_TOL after every step."""
    jsys_, tsys_ = _make(jsys, name), _make(tsys, name)
    step = jax.jit(lambda s: jsys_["step"](s, DT))
    pool = jsys_["create"](jax.random.PRNGKey(5))
    for _ in range(WARM_STEPS):
        pool = step(pool)
    pool = jax.device_get(pool)
    tpool = convert.particle_pool_from_numpy(pool, torch.Generator(), "cpu")
    emitted = draws.emissions(name, pool.rng, STEPS)
    for i in range(STEPS):
        pool = jax.device_get(step(pool))
        tpool = tsys_["step"](tpool, DT, draws=emitted[i])
        np.testing.assert_array_equal(tpool.alive.numpy(), pool.alive)
        np.testing.assert_allclose(tpool.emit_carry.numpy(), pool.emit_carry,
                                   rtol=0, atol=1e-6)
        for f in ("position", "velocity", "age", "lifetime"):
            np.testing.assert_allclose(_np(getattr(tpool, f)),
                                       getattr(pool, f), rtol=0,
                                       atol=STATE_TOL, err_msg=f)
        for k, v in pool.data.items():
            np.testing.assert_allclose(_np(tpool.data[k]), v, rtol=0,
                                       atol=STATE_TOL, err_msg=k)
    assert 0 < int(tpool.alive.sum()) <= SYSTEMS[name]["capacity"]


def test_pool_steps_from_its_generator():
    """Without draws a pool draws from its own generator: the same seed
    gives the same pool, another seed another; a full pool emits nothing
    more."""
    fire = tsys.make_fire_system(capacity=96, emit_rate=1800.0)
    pools = []
    for seed in (1, 1, 2):
        p = fire["create"](torch.Generator().manual_seed(seed))
        for _ in range(6):
            p = fire["step"](p, DT)
        pools.append(p)
    assert torch.equal(pools[0].position, pools[1].position)
    assert not torch.equal(pools[0].position, pools[2].position)
    assert int(pools[0].alive.sum()) == 96
    assert pools[0].generator.device.type == "cpu"


def test_fire_atlas_frame_matches_jax():
    rng = np.random.default_rng(0)
    age = rng.uniform(0, 2, 200).astype(np.float32)
    life = rng.uniform(-0.1, 2, 200).astype(np.float32)
    want = np.asarray(jsys.fire_atlas_frame(jnp.asarray(age),
                                            jnp.asarray(life)))
    got = tsys.fire_atlas_frame(torch.as_tensor(age), torch.as_tensor(life))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,descending", [(1000, False), (1000, True),
                                          (256, False), (77, True)])
def test_bitonic_kv_bit_equal(n, descending):
    """Keys with many ties (rounded normals), some +inf and -inf: keys and
    values bit-equal to JAX's network."""
    rng = np.random.default_rng(n)
    keys = np.round(rng.normal(size=n), 1).astype(np.float32)
    keys[rng.integers(0, n, n // 10)] = np.inf
    keys[rng.integers(0, n, n // 20)] = -np.inf
    vals = np.arange(n, dtype=np.int32)
    jk, jv = jsort.bitonic_sort_kv(jnp.asarray(keys), jnp.asarray(vals),
                                   descending=descending)
    tk, tv = tsort.bitonic_sort_kv(torch.as_tensor(keys),
                                   torch.as_tensor(vals),
                                   descending=descending)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # The network's order among ties is not the stable sort's.
    stable = np.argsort(-keys if descending else keys, kind="stable")
    assert not np.array_equal(tv.numpy(), stable)


def test_sort_particles_by_depth_and_self_test():
    """Back-to-front order of a fire pool, dead particles (key +inf) last
    in the network's order, equal to JAX's; both self-tests pass."""
    fire = jsys.make_fire_system(capacity=128)
    pool = fire["create"](jax.random.PRNGKey(9))
    step = jax.jit(lambda s: fire["step"](s, DT))
    for _ in range(20):
        pool = step(pool)
    cam = jnp.array([0.0, 2.0, -6.0])
    want = np.asarray(jsort.sort_particles_by_depth(pool.position, cam,
                                                    pool.alive))
    got = tsort.sort_particles_by_depth(torch.as_tensor(np.asarray(
        pool.position)), torch.as_tensor(np.asarray(cam)),
        torch.as_tensor(np.asarray(pool.alive)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not bool(np.asarray(pool.alive).all())
    for descending in (False, True):
        assert tsort.self_test(300, descending=descending, seed=2)
        assert jsort.self_test(300, descending=descending, seed=2)


def _jax_splat(img, camera, positions, alive, color, radius_px=2):
    """examples/showcase.py:327-350 (the script runs when imported)."""
    from d3d12renderer_tpu.core import maths as m

    h, w, _ = img.shape
    view = m.quat_inv_rotate(camera.rotation[None],
                             positions - camera.position)
    z = jnp.maximum(-view[:, 2], 1e-3)
    half_h = jnp.tan(camera.v_fov / 2)
    u = (view[:, 0] / (z * half_h * camera.aspect)) * 0.5 + 0.5
    v = (-view[:, 1] / (z * half_h)) * 0.5 + 0.5
    px = jnp.clip((u * (w - 1)).astype(jnp.int32), 0, w - 1)
    py = jnp.clip((v * (h - 1)).astype(jnp.int32), 0, h - 1)
    ok = alive & (-view[:, 2] > 0.1) & (u > 0) & (u < 1) & (v > 0) & (v < 1)
    out = img
    for dy in range(-radius_px, radius_px + 1):
        for dx in range(-radius_px, radius_px + 1):
            yy = jnp.clip(py + dy, 0, h - 1)
            xx = jnp.clip(px + dx, 0, w - 1)
            out = out.at[yy, xx].add(
                jnp.where(ok[:, None], color, 0.0) * 0.5)
    return out


def test_splat_particles_matches_jax():
    """The showcase's fire pool after 45 steps splatted onto a frame, with
    particles off screen and behind the camera among them: the same pixels
    within 1e-5 (overlapping squares accumulate)."""
    fire = jsys.make_fire_system(origin=(-2.0, 0.4, -2.0), capacity=256)
    pool = fire["create"](jax.random.PRNGKey(9))
    step = jax.jit(lambda s: fire["step"](s, DT))
    for _ in range(45):
        pool = step(pool)
    w, h = 96, 54
    cam = jcam.look_at((0.0, 7.5, -16.0), (0.0, 1.5, 0.0), aspect=w / h,
                       v_fov=math.radians(50))
    pos = np.asarray(pool.position).copy()
    pos[:8] = [[40.0, 0, 0]] * 4 + [[0.0, 7.5, -30.0]] * 4
    img = np.random.default_rng(1).uniform(0, 1, (h, w, 3)).astype(np.float32)
    color = np.array([1.0, 0.45, 0.1], np.float32)
    want = np.asarray(_jax_splat(jnp.asarray(img), cam, jnp.asarray(pos),
                                 pool.alive, jnp.asarray(color)))
    got = tsys.splat_particles(torch.as_tensor(img),
                               convert.camera_from_numpy(cam, "cpu"),
                               torch.as_tensor(pos),
                               torch.as_tensor(np.asarray(pool.alive)),
                               torch.as_tensor(color))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert (np.abs(want - img).max(-1) > 0).sum() > 25
