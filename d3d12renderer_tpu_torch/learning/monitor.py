"""Episode statistics of vectorized envs (counterpart of
``d3d12renderer_tpu/learning/monitor.py``): per-env return and length
accumulators and completed-episode aggregates as device tensors, folded
one env step at a time inside the training iteration, and a CSV log."""

from __future__ import annotations

import csv
import time
from dataclasses import dataclass

import torch


@dataclass
class EpisodeStats:
    running_return: torch.Tensor   # (B,)
    running_length: torch.Tensor   # (B,)
    episode_count: torch.Tensor    # ()
    return_sum: torch.Tensor       # ()
    length_sum: torch.Tensor       # ()
    best_return: torch.Tensor      # ()


def init_stats(num_envs: int, device="cuda") -> EpisodeStats:
    def zeros(*shape):
        return torch.zeros(shape, device=device)

    return EpisodeStats(
        running_return=zeros(num_envs), running_length=zeros(num_envs),
        episode_count=zeros(), return_sum=zeros(), length_sum=zeros(),
        best_return=torch.full((), -torch.inf, device=device))


def update_stats(stats: EpisodeStats, rewards, dones) -> EpisodeStats:
    """Fold one vectorized step (rewards (B,), dones (B,) bool)."""
    ret = stats.running_return + rewards
    length = stats.running_length + 1
    finished = dones.to(torch.float32)
    return EpisodeStats(
        running_return=ret * (1 - finished),
        running_length=length * (1 - finished),
        episode_count=stats.episode_count + finished.sum(),
        return_sum=stats.return_sum + (ret * finished).sum(),
        length_sum=stats.length_sum + (length * finished).sum(),
        best_return=torch.maximum(stats.best_return, torch.max(
            torch.where(dones, ret, torch.full_like(ret, -torch.inf)))))


def summarize(stats: EpisodeStats) -> dict:
    n = max(float(stats.episode_count), 1.0)
    return {
        "episodes": float(stats.episode_count),
        "mean_return": float(stats.return_sum) / n,
        "mean_length": float(stats.length_sum) / n,
        "best_return": float(stats.best_return),
    }


class MonitorCSV:
    """CSV episode log: one row of timesteps, mean return and length,
    episodes and wall time per `write`."""

    def __init__(self, path: str):
        self.path = path
        self._t0 = time.time()
        with open(path, "w", newline="") as f:
            csv.writer(f).writerow(["timesteps", "mean_return",
                                    "mean_length", "episodes", "walltime"])

    def write(self, timesteps: int, stats: EpisodeStats):
        s = summarize(stats)
        with open(self.path, "a", newline="") as f:
            csv.writer(f).writerow([
                timesteps, f"{s['mean_return']:.4f}",
                f"{s['mean_length']:.1f}", int(s["episodes"]),
                f"{time.time() - self._t0:.1f}",
            ])
