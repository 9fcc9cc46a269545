"""The eval frame path-traced across the ranks of a process group
(counterpart of ``d3d12renderer_tpu/parallel/eval_render.py``): the
frame's camera rays, in scanline order and padded to a multiple of the
world size, are split into one band of rows per rank, as JAX shards
them; each rank traces its band and an `all_gather` puts the frame
together on every rank."""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..render.camera import Camera, generate_rays
from ..render.pathtracer import (PathTracerSettings, Sampler, Scene,
                                 trace_sample)
from .data_parallel import rank_seed


def pathtrace_sharded(scene: Scene, camera: Camera, width: int, height: int,
                      group=None,
                      settings: PathTracerSettings = PathTracerSettings(),
                      spp: int = 1, seed: int = 0,
                      camera_sampler: Optional[Sampler] = None,
                      sampler: Optional[Sampler] = None) -> torch.Tensor:
    """(H, W, 3) linear radiance, the same on every rank of `group` (None:
    this process alone).

    The camera rays (one set for all `spp` samples, as in JAX) come from
    `camera_sampler`, by default seeded `seed` on every rank, so that every
    rank makes the same rays; rank r traces rays [r n, (r + 1) n) of them
    in scanline order (JAX's bands), with its own `sampler`, by default
    seeded `rank_seed(seed, r)` (JAX folds the shard index into its trace
    keys).  `pathtracer.render` traces in 32x32 tile order instead, so at
    world size 1 the frame is render's at spp 1 when every per-ray draw of
    `sampler` is render's put back in scanline order."""
    rank = 0 if group is None else dist.get_rank(group)
    world = 1 if group is None else dist.get_world_size(group)
    dev = camera.position.device
    if camera_sampler is None:
        camera_sampler = Sampler(torch.Generator(device=dev).manual_seed(seed))
    if sampler is None:
        sampler = Sampler(torch.Generator(device=dev).manual_seed(
            rank_seed(seed, rank)))
    f_num = settings.f_number if settings.use_thin_lens else 0.0
    o, d = generate_rays(camera, width, height, camera_sampler,
                         f_number=f_num, focal_length=settings.focal_length)
    r = width * height
    pad = (-r) % world
    o = torch.cat([o, o.new_zeros((pad, 3))])
    d = torch.cat([d, d.new_ones((pad, 3))])
    band = (r + pad) // world
    o, d = o[rank * band:(rank + 1) * band], d[rank * band:(rank + 1) * band]
    rad = torch.zeros((band, 3), device=dev)
    for _ in range(spp):
        rad = rad + trace_sample(scene, settings, o, d, sampler)[0]
    rad = rad / spp
    if world > 1:
        bands = [torch.empty_like(rad) for _ in range(world)]
        dist.all_gather(bands, rad.contiguous(), group=group)
        rad = torch.cat(bands)
    return rad[:r].reshape(height, width, 3)
