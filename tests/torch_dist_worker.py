"""Processes for the data-parallel tests (`tests/test_torch_distributed.py`):
each rank joins a gloo group through a file under the test's temporary
directory (no port is chosen), with a timeout on the join and on every
collective, runs the port's side from the inputs the test wrote, and
writes its results beside them.  This module imports the port alone (no
JAX), so that the spawned processes start quickly."""

from __future__ import annotations

import datetime
import math
import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# Every join and collective of a rank fails after this long, so that a
# hang fails the test instead of the suite's clock.
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=90)
JOIN_TIMEOUT_S = 240


def spawn(fn, world: int, workdir: str, *args):
    """Run `fn(rank, world, workdir, *args)` in `world` spawned processes
    and wait for all of them (at most JOIN_TIMEOUT_S); a failed or hung
    rank raises."""
    ctx = mp.start_processes(_run, args=(fn, world, workdir) + args,
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{fn.__name__}: ranks still running after "
                               f"{JOIN_TIMEOUT_S} s")


def _run(rank, fn, world, workdir, *args):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "pg"),
        rank=rank, world_size=world, timeout=COLLECTIVE_TIMEOUT)
    try:
        fn(rank, world, workdir, *args)
    finally:
        dist.destroy_process_group()


def load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def dump(path, obj):
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def ppo_rank(rank, world, workdir, config):
    """One data-parallel iteration from the rank's state with JAX's draws
    (`state_<rank>.bin`, `draws_<rank>.pkl`); then a sharded checkpoint of
    the new state, read back, and one more iteration (the generators'
    own draws) from the state and from the restored copy.  Writes
    `out_<rank>.bin`: (state, metrics, next state from the state, next
    state from the copy, next metrics of each, restored state), the first
    and the last as they were before the next iteration."""
    from d3d12renderer_tpu_torch.learning.loco_env import LocoEnv
    from d3d12renderer_tpu_torch.learning.ppo import Draws, PPOConfig
    from d3d12renderer_tpu_torch.parallel.data_parallel import (
        make_distributed_ppo, train_state_spec)
    from d3d12renderer_tpu_torch.utils import checkpoint

    state = checkpoint.load_pytree(os.path.join(workdir, f"state_{rank}.bin"))
    noise, pokes, perms = load(os.path.join(workdir, f"draws_{rank}.pkl"))
    draws = Draws(noise=torch.as_tensor(noise),
                  pokes=[(torch.as_tensor(d), torch.as_tensor(p).long(),
                          torch.as_tensor(t)) for d, p, t in pokes],
                  perms=torch.as_tensor(perms).long())
    _, train, _ = make_distributed_ppo(LocoEnv(device="cpu"),
                                       PPOConfig(**config))
    new, metrics = train(state, draws)
    path = os.path.join(workdir, "ckpt.bin")
    checkpoint.save_pytree_sharded(path, new, train_state_spec())
    # The default device: each part on this rank's own device of the kind
    # it was saved from (here the CPU).
    restored = checkpoint.load_pytree_sharded(path, train_state_spec())
    for x in checkpoint.tree_leaves(restored):
        if isinstance(x, (torch.Tensor, torch.Generator)):
            assert x.device == torch.device("cpu"), x.device
    # Copies for the record: the next iteration advances the generators
    # (tensors are never changed in place).
    record = [_copy_generators(x) for x in (new, restored)]
    a, ma = train(new)
    b, mb = train(restored)
    checkpoint.save_pytree(os.path.join(workdir, f"out_{rank}.bin"),
                           (record[0], metrics, a, b, ma, mb, record[1]))


def _copy_generators(tree):
    def copy(x):
        if not isinstance(x, torch.Generator):
            return x
        out = torch.Generator(device=x.device)
        out.set_state(x.get_state())
        return out

    from d3d12renderer_tpu_torch.utils.checkpoint import tree_map

    return tree_map(copy, tree)


def render_rank(rank, world, workdir, w, h):
    """`pathtrace_sharded` of the test scene at w x h, depth 1, 1 spp, with
    JAX's camera draws and this rank's band draws replayed
    (`draws.pkl`); writes `frame_<rank>.npy`."""
    from d3d12renderer_tpu_torch.parallel.eval_render import pathtrace_sharded
    from d3d12renderer_tpu_torch.render import pathtracer as tpt

    scene, camera = sharded_scene("cpu")
    cam_draws, band_draws = load(os.path.join(workdir, "draws.pkl"))
    cam_sampler = ReplaySampler(cam_draws)
    sampler = ReplaySampler(band_draws[rank])
    frame = pathtrace_sharded(
        scene, camera, w, h, dist.group.WORLD,
        settings=tpt.PathTracerSettings(recursion_depth=1), spp=1,
        camera_sampler=cam_sampler, sampler=sampler)
    assert not cam_sampler.draws and not sampler.draws
    np.save(os.path.join(workdir, f"frame_{rank}.npy"), frame.numpy())


SHARDED_MATERIALS = dict(
    albedo=np.array([[0.5, 0.5, 0.5], [0.8, 0.2, 0.2]], np.float32),
    emissive=np.zeros((2, 3), np.float32),
    roughness=np.array([0.7, 0.4], np.float32),
    metallic=np.zeros(2, np.float32))
SHARDED_CAMERA = dict(eye=(4.0, 3.0, 5.0), target=(0.0, 0.8, 0.0),
                      v_fov=math.radians(50), aspect=1.0)


def sharded_meshes(mm):
    """`__graft_entry__._dryrun_impl`'s eval scene: a ground quad and a
    sphere."""
    return [(mm.quad(half=6.0), 0),
            (mm.ico_sphere(1.0, 1).transformed(translate=(0, 1.0, 0)), 1)]


def sharded_scene(device):
    from d3d12renderer_tpu_torch.render import bvh as tbvh
    from d3d12renderer_tpu_torch.render import mesh as tmesh
    from d3d12renderer_tpu_torch.render import pathtracer as tpt
    from d3d12renderer_tpu_torch.render.camera import look_at

    mats = tpt.Materials(**{k: torch.as_tensor(v, device=device)
                            for k, v in SHARDED_MATERIALS.items()})
    scene = tpt.Scene(bvh=tbvh.build_bvh(sharded_meshes(tmesh), device=device),
                      materials=mats, sky=tpt.default_sky(device=device))
    return scene, look_at(**SHARDED_CAMERA, device=device)


class ReplaySampler:
    """Hands out recorded draws in order; each call must ask for the
    recorded kind and shape (tests/test_torch_pathtracer.py's)."""

    def __init__(self, draws):
        self.draws = list(draws)

    def _next(self, kind, shape):
        got_kind, x = self.draws.pop(0)
        assert got_kind == kind and tuple(x.shape) == tuple(shape), (
            kind, shape, got_kind, x.shape)
        return torch.as_tensor(np.array(x))

    def uniform(self, shape):
        return self._next("uniform", shape)

    def normal(self, shape):
        return self._next("normal", shape)

    def randint(self, shape, high):
        return self._next("randint", shape).to(torch.int64)


def ScanlineSampler(generator, width: int, height: int):
    """A `pathtracer.Sampler` on `generator` whose per-ray draws (first
    axis the frame's pixel count) are `pathtracer.render`'s put back in
    scanline order: render traces pixel perm[j] with draw j, so pixel i
    takes draw inv[i] (`pathtracer._tile_perm`).  The camera's draws, of
    the image's shape, stay as they are."""
    from d3d12renderer_tpu_torch.render import pathtracer as tpt

    inv = torch.as_tensor(tpt._tile_perm(width, height)[1],
                          device=generator.device)

    class Scanline(tpt.Sampler):
        def _scanline(self, x):
            return x[inv] if x.dim() and x.shape[0] == inv.shape[0] else x

        def uniform(self, shape):
            return self._scanline(super().uniform(shape))

        def normal(self, shape):
            return self._scanline(super().normal(shape))

    return Scanline(generator)
