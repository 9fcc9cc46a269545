"""On the card: the control (the reference in bfloat16 in the program's
place) comes out not correct, and the program correct, for every cell, at a
size a test run holds."""

import copy
import time

import pytest

from portbench import harness, make_benchmark

# Per cell: configuration overrides that make the run short.
SMALL = {
    "ragdoll_loco_4096.rollout": {"envs": 512},
    "ragdoll_loco_4096.ppo": {"envs": 512},
    "atrium_1080p.pathtrace": {},
    "atrium_1080p.raster": {},
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", [n for n, _ in make_benchmark.cells()])
def test_control_fails_and_program_passes(name, card):
    import torch

    cell = harness.Cell.load(name, seed=101, seconds=4.0, trace=False)
    cell.config = copy.deepcopy(cell.config)
    cell.config.update(SMALL[name])
    driver = harness.load_driver(cell)
    run = harness.Run(cell)

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    harness.run_window(driver, run, time.perf_counter(),
                       torch.cuda.synchronize, event)
    driver.free()
    limits = cell.workload["limits"]
    gaps, checked = driver.check(run)
    assert checked > 0
    assert all(gaps[k] <= limits[k] for k in limits), gaps
    control = driver.control(run, torch.bfloat16)
    assert any(control[k] > limits[k] for k in control), control
