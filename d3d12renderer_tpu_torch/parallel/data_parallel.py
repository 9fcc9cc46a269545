"""Data-parallel PPO over `torch.distributed` (counterpart of
``d3d12renderer_tpu/parallel/data_parallel.py``).

Every rank of a process group runs its own shard of the envs; the learner
stays replicated because each minibatch's advantage statistics and
gradients are averaged over the ranks (`ppo.make_ppo(group=)`), so every
rank applies the same update.  The metrics are averaged, the episode
counters summed and the best return maxed over the ranks, so that they
too are the same on every rank.  `join_process_group` joins the group
from the usual environment variables (`torchrun`) or alone, at world
size 1.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ..learning.loco_env import LocoEnv
from ..learning.monitor import EpisodeStats
from ..learning.ppo import PPOConfig, TrainState, all_mean, make_ppo
from ..utils.checkpoint import REPLICATED, SHARDED


def train_state_spec() -> TrainState:
    """Which parts of a distributed TrainState are the same on every rank
    (REPLICATED: the parameters and the optimizer state, the episode
    aggregates) and which are each rank's own slice of the envs or its own
    generator (SHARDED: the env state, `last_obs`, `rng`, the per-env
    running return and length)."""
    return TrainState(
        params=REPLICATED, opt_state=REPLICATED, env_state=SHARDED,
        last_obs=SHARDED, rng=SHARDED,
        stats=EpisodeStats(
            running_return=SHARDED, running_length=SHARDED,
            episode_count=REPLICATED, return_sum=REPLICATED,
            length_sum=REPLICATED, best_return=REPLICATED))


def rank_seed(seed: int, rank: int, stream: int = 0) -> int:
    """A generator seed for (`seed`, `rank`, `stream`): the rank folded
    into the seed, as JAX folds a shard index into its keys."""
    return int(np.random.SeedSequence((seed, rank, stream))
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


def rank_generator(seed: int, rank: int, stream: int,
                   device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        rank_seed(seed, rank, stream))


def make_distributed_ppo(env: LocoEnv, config: PPOConfig, group=None):
    """(init, train, policy_apply) for one rank of `group` (the default
    group when None).  `config.num_envs` is the count on each rank.

    * `init(seed=0) -> TrainState`: the parameters from one seed on every
      rank (`make_ppo`'s init); the env's poke generator and `rng` seeded
      per rank (`rank_seed`), so that every rank draws its own pokes,
      action noise and permutations.
    * `train(state, draws=None, profile_phases=False) -> (state,
      metrics)`: one iteration on this rank's envs with the advantage
      statistics and gradients averaged over the group; metrics averaged;
      the episode count and the return and length sums advanced by the sum
      of every rank's increments, the best return the largest of the
      ranks'.  `draws` (`ppo.Draws`) replaces this rank's draws."""
    group = group if group is not None else dist.group.WORLD
    init_local, train_local, policy_apply = make_ppo(env, config, group=group)
    device = env.device

    def init(seed: int = 0) -> TrainState:
        rank = dist.get_rank(group)
        state = init_local(seed)
        env_state = dataclasses.replace(
            state.env_state, generator=rank_generator(seed, rank, 0, device))
        return state._replace(env_state=env_state,
                              rng=rank_generator(seed, rank, 1, device))

    def train(state: TrainState, draws=None, profile_phases: bool = False):
        new, metrics = train_local(state, draws, profile_phases)
        phase_ms = metrics.pop("phase_ms", None)
        names = list(metrics)
        means = all_mean(torch.stack([metrics[k] for k in names]), group)
        metrics = dict(zip(names, means.unbind()))
        if phase_ms is not None:
            metrics["phase_ms"] = phase_ms
        old, st = state.stats, new.stats
        deltas = torch.stack([st.episode_count - old.episode_count,
                              st.return_sum - old.return_sum,
                              st.length_sum - old.length_sum])
        dist.all_reduce(deltas, group=group)
        best = st.best_return.clone()
        dist.all_reduce(best, op=dist.ReduceOp.MAX, group=group)
        stats = dataclasses.replace(
            st, episode_count=old.episode_count + deltas[0],
            return_sum=old.return_sum + deltas[1],
            length_sum=old.length_sum + deltas[2], best_return=best)
        return new._replace(stats=stats), metrics

    return init, train, policy_apply


def join_process_group(device: torch.device):
    """Join the default process group, or keep the one already joined;
    returns (group, device of this rank).  NCCL on a CUDA device, gloo on
    the CPU.  With RANK, WORLD_SIZE and MASTER_ADDR set (`torchrun`), the
    group of those ranks, each on the card of its LOCAL_RANK; without them,
    a group of this process alone through a file store in the temporary
    directory."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", 0))
        device = torch.device("cuda", local % torch.cuda.device_count())
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group uses {dist.get_backend()},"
                               f" not {backend} for {device}")
        return dist.group.WORLD, device
    if all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        dist.init_process_group(backend, init_method="env://")
    else:
        fd, path = tempfile.mkstemp(prefix="d3d12_torch_pg_")
        os.close(fd)
        os.remove(path)
        dist.init_process_group(backend, init_method=f"file://{path}",
                                rank=0, world_size=1)
    return dist.group.WORLD, device
