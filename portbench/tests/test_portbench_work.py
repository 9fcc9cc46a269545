"""The work counts of the rooflines at the cells' real shapes."""

import pytest

from portbench import harness, peaks
from portbench.work import bvh_walk, fused_substep


def test_fused_substep_work_at_4096_envs():
    cfg = harness.load_json("configs", "ragdoll_loco_4096")
    flop, bytes_moved = fused_substep.work(cfg, 0)
    # 30 iterations x 4096 envs x (7 cone-twist x 255 + 6 hinge x 250).
    assert flop == 30 * 4096 * (7 * 255 + 6 * 250) == 403_660_800
    # Body state in and out (19 floats x 14 bodies x 2), action, obs,
    # reward and done.
    assert bytes_moved == 4 * 4096 * (2 * 19 * 14 + 27 + 66 + 2) == 10_272_768
    # About 7 active plane-contact points an env: ~0.48 GFLOP, op-bound,
    # ~0.0072 ms a launch.
    flop, bytes_moved = fused_substep.work(cfg, 7 * 4096)
    assert 1e3 * peaks.least_seconds(flop, bytes_moved) == pytest.approx(
        0.0072, abs=0.0002)


def test_bvh_walk_bytes_of_a_frame():
    cfg = harness.load_json("configs", "atrium_1080p")
    _, bytes_moved = bvh_walk.work(cfg, 0, 1)
    assert bytes_moved == 4 * 256_798 * 36
    # ~6M rays a frame (primary, bounces, shadow rays): ~0.09 ms.
    _, bytes_moved = bvh_walk.work(cfg, 6_000_000, 1)
    assert 1e3 * peaks.least_seconds(0.0, bytes_moved) == pytest.approx(
        0.09, abs=0.005)
