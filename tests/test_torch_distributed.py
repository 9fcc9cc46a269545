"""The port's data-parallel training and sharded eval render
(`parallel/`, `utils/checkpoint.py`'s sharded round trip) against the JAX
package's on the CPU.  The port runs 2 ranks, spawned processes in a gloo
group joined through a file under the test's temporary directory
(`tests/torch_dist_worker.py`); JAX runs `make_distributed_ppo` /
`pathtrace_sharded` on a 2-device CPU mesh (tests/conftest.py gives 8).
JAX's draws are rebuilt from each shard's keys and injected, as
tests/test_torch_ppo.py does for one device."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from d3d12renderer_tpu.learning import ppo as jppo
from d3d12renderer_tpu.learning.loco_env import LocoEnv as JaxLocoEnv
from d3d12renderer_tpu.parallel import data_parallel as jdp
from d3d12renderer_tpu.parallel.eval_render import (
    pathtrace_sharded as j_pathtrace_sharded)
from d3d12renderer_tpu.physics.types import PhysicsSettings as JaxSettings
from d3d12renderer_tpu.render import bvh as jbvh
from d3d12renderer_tpu.render import camera as jcam
from d3d12renderer_tpu.render import mesh as jmesh
from d3d12renderer_tpu.render import pathtracer as jpt
from d3d12renderer_tpu_torch import convert
from d3d12renderer_tpu_torch.convert import _state_dict_from_flax
from d3d12renderer_tpu_torch.learning.ppo import TrainState
from d3d12renderer_tpu_torch.parallel import data_parallel as tdp
from d3d12renderer_tpu_torch.utils import checkpoint

from tests import torch_dist_worker as worker
from tests.test_torch_ppo import _poke_draws

torch.set_num_threads(1)
WORLD = 2
B, T, MINIBATCHES, EPOCHS = 4, 3, 2, 2         # B envs on each rank
CONFIG = dict(num_envs=B, rollout_steps=T, minibatches=MINIBATCHES,
              epochs=EPOCHS)
JAX_SETTINGS = JaxSettings(frame_rate=60, fused_substep="off",
                           solver_backend="xla")
FALLEN_ENV = 1       # sunk into the ground on every shard: ends an episode


def _shard_draws(rng, env_keys):
    """One shard's draws of JAX's iteration from its keys
    (tests/test_torch_ppo.py's `_jax_draws` at this shard's size)."""
    noise, perms = [], []
    for _ in range(T):
        rng, k_act = jax.random.split(rng)
        noise.append(np.asarray(jax.random.normal(k_act, (B, 27))))
    for _ in range(EPOCHS):
        rng, k = jax.random.split(rng)
        perms.append(np.asarray(jax.random.permutation(k, B * T)))
    keys, pokes = env_keys, []
    draw = jax.jit(jax.vmap(_poke_draws))
    for _ in range(T):
        keys, do, part, theta = draw(keys)
        pokes.append((np.asarray(do), np.asarray(part), np.asarray(theta)))
    return np.stack(noise), pokes, np.stack(perms)


@pytest.fixture(scope="module")
def ppo_run(tmp_path_factory):
    """JAX's 2-device iteration and the port's 2 ranks from the same
    global state (one env sunk per shard), with the per-shard draws."""
    env = JaxLocoEnv(settings=JAX_SETTINGS)
    mesh = jdp.make_mesh(WORLD)
    init, train, _ = jdp.make_distributed_ppo(env, jppo.PPOConfig(**CONFIG),
                                              mesh)
    state = jax.device_get(init(jax.random.PRNGKey(5)))
    pos = np.array(state.env_state.bodies.pos)
    pos[FALLEN_ENV::B, :, 1] -= 1.5
    state = state._replace(env_state=state.env_state.replace(
        bodies=state.env_state.bodies.replace(pos=pos)))
    want_state, want_metrics = jax.device_get(train(state))

    workdir = tmp_path_factory.mktemp("ppo")
    for rank in range(WORLD):
        rows = slice(rank * B, (rank + 1) * B)
        worker.dump(workdir / f"draws_{rank}.pkl", _shard_draws(
            state.rng[rank], state.env_state.rng[rows]))
        checkpoint.save_pytree(
            str(workdir / f"state_{rank}.bin"),
            convert.distributed_train_state_from_numpy(state, rank, WORLD,
                                                       "cpu"))
    worker.spawn(worker.ppo_rank, WORLD, str(workdir), CONFIG)
    outs = [checkpoint.load_pytree(str(workdir / f"out_{r}.bin"))
            for r in range(WORLD)]
    return {"start": state, "want": (want_state, want_metrics),
            "outs": outs, "workdir": workdir}


def test_iteration_matches_jax(ppo_run):
    """Every rank's parameters moved as JAX's within 1e-5 absolute
    (tests/test_torch_ppo.py's bar for one device) and equal on both ranks
    bit for bit; adam's
    moments within 1e-4 of their largest entry; the metrics (averaged over
    the ranks) within 1e-4 relative; the env state of each rank's shard as
    JAX's."""
    start = _state_dict_from_flax(ppo_run["start"].params)
    want_state, want_metrics = ppo_run["want"]
    outs = ppo_run["outs"]
    for name, w in _state_dict_from_flax(want_state.params).items():
        for new, *_ in outs:
            np.testing.assert_allclose(new.params[name].numpy() - start[name],
                                       w - start[name], atol=1e-5, rtol=0,
                                       err_msg=name)
        assert torch.equal(outs[0][0].params[name], outs[1][0].params[name])
    adam = want_state.opt_state[1][0]
    for new, *_ in outs:
        assert int(new.opt_state.count) == int(adam.count) == EPOCHS * MINIBATCHES
        for got, w in ((new.opt_state.mu, adam.mu), (new.opt_state.nu,
                                                      adam.nu)):
            for name, x in _state_dict_from_flax(w).items():
                np.testing.assert_allclose(got[name].numpy(), x,
                                           atol=1e-4 * np.abs(x).max(),
                                           err_msg=name)
    for rank, (new, metrics, *_) in enumerate(outs):
        assert set(metrics) == set(want_metrics)
        for k, w in want_metrics.items():
            np.testing.assert_allclose(metrics[k].item(), float(w), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        rows = slice(rank * B, (rank + 1) * B)
        np.testing.assert_allclose(new.last_obs.numpy(),
                                   np.asarray(want_state.last_obs)[rows],
                                   atol=5e-5)
        np.testing.assert_array_equal(
            new.env_state.steps.numpy(),
            np.asarray(want_state.env_state.steps)[rows])


def test_episode_stats_are_summed_and_maxed(ppo_run):
    """The episode count and the return and length sums hold every shard's
    episodes (JAX's psum of increments), the best return the best of the
    shards (pmax), the same on both ranks; the running sums are each
    shard's own."""
    want_state, _ = ppo_run["want"]
    assert float(want_state.stats.episode_count) >= WORLD
    for rank, (new, *_) in enumerate(ppo_run["outs"]):
        for f in ("episode_count", "return_sum", "length_sum",
                  "best_return"):
            np.testing.assert_allclose(
                getattr(new.stats, f).numpy(),
                np.asarray(getattr(want_state.stats, f)), atol=1e-4,
                err_msg=f)
        rows = slice(rank * B, (rank + 1) * B)
        for f in ("running_return", "running_length"):
            np.testing.assert_allclose(
                getattr(new.stats, f).numpy(),
                np.asarray(getattr(want_state.stats, f))[rows], atol=1e-4,
                err_msg=f)


def _leaves_equal(a, b):
    for x, y in zip(checkpoint.tree_leaves(a), checkpoint.tree_leaves(b),
                    strict=True):
        if isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state())
        elif isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


def test_sharded_checkpoint_round_trip(ppo_run):
    """The file holds the global state (the shards gathered in rank order,
    both ranks' generators); each rank reads back its own state bit for
    bit, on its own device by default (the worker checks every leaf), and
    the next iteration from the restored state equals the one from the
    state never saved, bit for bit (the generators' own draws)."""
    outs = ppo_run["outs"]
    for new, _, a, b, ma, mb, restored in outs:
        _leaves_equal(restored, new)
        _leaves_equal(a, b)
        for k in ma:
            assert torch.equal(ma[k], mb[k]), k
        assert not torch.equal(a.params["pi_0.weight"],
                               new.params["pi_0.weight"])
    whole = checkpoint._read(str(ppo_run["workdir"] / "ckpt.bin"))
    assert whole.last_obs.array.shape == (WORLD * B, outs[0][0].last_obs.shape[1])
    np.testing.assert_array_equal(
        whole.last_obs.array,
        np.concatenate([o[0].last_obs.numpy() for o in outs]))
    assert len(whole.rng.states) == WORLD


def test_sharded_load_puts_card_parts_on_the_rank_s_card(monkeypatch):
    """By default a part that rank 0 saved from its card goes to the
    loading rank's current card, not to rank 0's; a CPU part stays on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert checkpoint.rank_device("cuda:0") == "cuda:3"
    assert checkpoint.rank_device("cuda") == "cuda:3"
    assert checkpoint.rank_device("cpu") == "cpu"


def _spec_leaves(tree, prefix=""):
    """{path: kind} of a spec tree, JAX's (PartitionSpecs) or the port's."""
    if isinstance(tree, P):
        return {prefix: "sharded" if len(tree) else "replicated"}
    if isinstance(tree, str):
        return {prefix: tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        items = ((f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree))
    out = {}
    for name, sub in items:
        out.update(_spec_leaves(sub, f"{prefix}.{name}"))
    return out


def test_train_state_spec_matches_jax():
    want = _spec_leaves(jdp.train_state_spec())
    got = _spec_leaves(tdp.train_state_spec())
    assert got == want
    assert set(want.values()) == {"sharded", "replicated"}
    assert isinstance(tdp.train_state_spec(), TrainState)


def test_rank_seeds_differ():
    seeds = {tdp.rank_seed(0, r, s) for r in range(4) for s in range(2)}
    assert len(seeds) == 8 and tdp.rank_seed(0, 1) == tdp.rank_seed(0, 1)


# One 32x32 tile of the path tracer, where its tile order is scanline
# order; and 2 x 2 tiles, where the two orders differ.
W_R = H_R = 16
W_TILES, H_TILES = 64, 48


def _render_run(tmp_path_factory, w, h):
    """JAX's `pathtrace_sharded` on a 2-device mesh at w x h (depth 1,
    1 spp); the draws it makes, recorded from the same computation run
    eagerly band by band (tests/test_multichip.py's reference); the port's
    2 ranks with those draws replayed."""
    bvh = jbvh.build_bvh(worker.sharded_meshes(jmesh), cache=False)
    mats = jpt.Materials(**{k: jnp.asarray(v)
                            for k, v in worker.SHARDED_MATERIALS.items()})
    scene = jpt.Scene(bvh=bvh, materials=mats, sky=jpt.default_sky())
    cam = jcam.look_at(**worker.SHARDED_CAMERA)
    settings = jpt.PathTracerSettings(recursion_depth=1)
    key = jax.random.PRNGKey(3)
    want = np.asarray(j_pathtrace_sharded(scene, cam, w, h,
                                          jdp.make_mesh(WORLD),
                                          settings=settings, spp=1, key=key))

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
        k_cam, k_trace = jax.random.split(key)
        o, d = jcam.generate_rays(cam, w, h, key=k_cam)
        cam_draws = list(draws)
        shard_keys = jax.random.split(k_trace, WORLD)
        rows = w * h // WORLD
        band_draws = []
        for i in range(WORLD):
            del draws[:]
            band = slice(i * rows, (i + 1) * rows)
            jpt.trace_sample(scene, settings, o[band], d[band],
                             jax.random.fold_in(shard_keys[i], 0))
            band_draws.append(list(draws))
    finally:
        mp.undo()
    workdir = tmp_path_factory.mktemp(f"render_{w}x{h}")
    worker.dump(workdir / "draws.pkl", (cam_draws, band_draws))
    worker.spawn(worker.render_rank, WORLD, str(workdir), w, h)
    frames = [np.load(workdir / f"frame_{r}.npy") for r in range(WORLD)]
    return want, frames


@pytest.fixture(scope="module")
def render_run(tmp_path_factory):
    return _render_run(tmp_path_factory, W_R, H_R)


@pytest.fixture(scope="module")
def render_run_tiles(tmp_path_factory):
    return _render_run(tmp_path_factory, W_TILES, H_TILES)


def _check_sharded_frame(run, w, h):
    """Both ranks hold the same whole frame; against JAX's sharded frame
    per pixel, the path tracer's criterion (>= 99% of pixels within 1e-3
    absolute + 1e-3 relative: one flipped hit changes a whole path)."""
    want, frames = run
    np.testing.assert_array_equal(frames[0], frames[1])
    got = frames[0]
    assert got.shape == (h, w, 3) and np.isfinite(got).all()
    assert got.std() > 1e-3
    close = np.all(np.abs(got - want) <= 1e-3 + 1e-3 * np.abs(want), -1)
    assert close.mean() >= 0.99, close.mean()


def test_pathtrace_sharded_matches_jax(render_run):
    """At 16x16 (one tile), by `_check_sharded_frame`'s criterion."""
    _check_sharded_frame(render_run, W_R, H_R)


def test_pathtrace_sharded_bands_match_jax_across_tiles(render_run_tiles):
    """At 64x48 (2 x 2 tiles of the path tracer, whose tile order is not
    scanline order) every rank traces JAX's scanline band with JAX's
    draws, by `_check_sharded_frame`'s criterion."""
    _check_sharded_frame(render_run_tiles, W_TILES, H_TILES)


def test_pathtrace_sharded_alone_is_render():
    """Without a group, at 70x40 (3 x 2 tiles, the last ones partial), with
    render's draws put back in scanline order, the frame is
    `pathtracer.render`'s at 1 spp bit for bit."""
    from d3d12renderer_tpu_torch.parallel.eval_render import pathtrace_sharded
    from d3d12renderer_tpu_torch.render import pathtracer as tpt

    w, h = 70, 40
    scene, camera = worker.sharded_scene("cpu")
    settings = tpt.PathTracerSettings(recursion_depth=1)
    g = torch.Generator().manual_seed(4)
    got = pathtrace_sharded(scene, camera, w, h, settings=settings,
                            camera_sampler=tpt.Sampler(g),
                            sampler=worker.ScanlineSampler(g, w, h))
    want, _ = tpt.render(scene, camera, w, h, settings, spp=1,
                         sampler=tpt.Sampler(torch.Generator().manual_seed(4)))
    assert torch.equal(got, want)


def test_distributed_entry_on_cpu():
    """`distributed_entry(device="cpu")` without torchrun's variables:
    gloo at world size 1 through a file store; one iteration moves the
    parameters, its metrics finite; the same group is kept by a second
    call."""
    import torch.distributed as dist

    from d3d12renderer_tpu_torch.entry import distributed_entry

    assert not dist.is_initialized()
    try:
        init, train, policy_apply = distributed_entry(
            device="cpu", envs=2, rollout=2, minibatches=1, epochs=1)
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        state = init(0)
        new, metrics = train(state)
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
        assert not torch.equal(new.params["pi_0.weight"],
                               state.params["pi_0.weight"])
        assert policy_apply(new.params, new.last_obs)[0].shape == (2, 27)
        distributed_entry(device="cpu", envs=2, rollout=2, minibatches=1,
                          epochs=1)
        assert dist.get_world_size() == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
