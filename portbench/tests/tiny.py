"""Run a cell through the harness on the CPU at a tiny size, the chip's
look skipped."""

from __future__ import annotations

import copy
import time

from portbench import harness

# Per cell: (seconds, overrides of its configuration and traffic).
TINY = {
    "ragdoll_loco_4096.rollout": (
        4.0, {"config": {"envs": 8},
              "traffic": {"warmup_calls": 1, "check_from": 2, "check_to": 6,
                          "checked_calls": 2, "trace_calls": 2}}),
    "ragdoll_loco_4096.ppo": (
        4.0, {"config": {"envs": 8, "ppo": {
            "rollout_steps": 4, "minibatches": 2, "epochs": 2, "gamma": 0.99,
            "gae_lambda": 0.95, "clip_eps": 0.1, "vf_coef": 0.5,
            "ent_coef": 0.0, "max_grad_norm": 0.5, "learning_rate": 2.5e-5}},
              "traffic": {"followed_iterations": 2, "trace_calls": 1}}),
    "atrium_1080p.pathtrace": (
        1.0, {"config": {"width": 16, "height": 8},
              "traffic": {"warmup_calls": 1, "check_from": 0, "check_to": 1,
                          "checked_calls": 1, "checked_pixels": 128,
                          "trace_calls": 1}}),
    "atrium_1080p.raster": (
        1.0, {"config": {"width": 64, "height": 32, "raster": {
            "primary": "raster", "half_res_effects": True, "sun_cascades": 3,
            # The plain walk on the CPU tests every ray against every row.
            "cascade_resolution": 4, "taa": True}},
              "traffic": {"warmup_calls": 1, "check_from": 0, "check_to": 1,
                          "checked_calls": 1, "texel_grid": 4,
                          "trace_calls": 1}}),
}


class HostEvent:
    """A CUDA event's two methods on the host's clock."""

    def __init__(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other) -> float:
        return 1e3 * (other.t - self.t)

    def synchronize(self):
        pass


def tiny_cell(name: str, seed: int = 7, trace: bool = False):
    seconds, overrides = TINY[name]
    cell = harness.Cell.load(name, seed, seconds, trace, device="cpu")
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = copy.deepcopy(cell.traffic)
    for part, values in overrides.items():
        getattr(cell, part).update(values)
    return cell


def run_tiny(name: str, seed: int = 7, trace: bool = False) -> dict:
    from d3d12renderer_tpu_torch import entry

    cell = tiny_cell(name, seed, trace)
    # The raster driver sets the entry's cascade size for its run.
    saved = entry.RASTER_SHADOW_RESOLUTION
    try:
        return harness.execute(cell, time.perf_counter(), lambda: None,
                               HostEvent, lambda: {"platform": "cpu"})
    finally:
        entry.RASTER_SHADOW_RESOLUTION = saved
