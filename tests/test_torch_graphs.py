"""`core/graphs.py` on the CPU: the launch tally that keeps the kernel
wrappers' counts true through CUDA-graph replays (a capture's launches
given back, then added per replay), the trees of tensors a captured call
takes and returns, `Graphed` and the physics runner running eagerly on CPU
tensors, and the entry's frame graph counting through the tally."""

from dataclasses import dataclass
from types import SimpleNamespace
from typing import Optional

import pytest
import torch

from d3d12renderer_tpu_torch.core import graphs


def _wrappers():
    return {"colored": SimpleNamespace(launches=5),
            "blur": SimpleNamespace(launches=0),
            "bvh": SimpleNamespace(launches=2)}


def test_tally_gives_back_a_capture_and_counts_replays():
    w = _wrappers()
    tally = graphs.LaunchTally(w)
    with tally.capturing():
        w["colored"].launches += 2          # one frame: two substeps
        w["blur"].launches += 7
    assert {k: v.launches for k, v in w.items()} == {
        "colored": 5, "blur": 0, "bvh": 2}
    assert tally.per_replay == {"colored": 2, "blur": 7}
    tally.replayed()
    tally.replayed(3)
    assert {k: v.launches for k, v in w.items()} == {
        "colored": 13, "blur": 28, "bvh": 2}


def test_tally_gives_back_a_failed_capture():
    w = _wrappers()
    tally = graphs.LaunchTally(w)
    with pytest.raises(RuntimeError):
        with tally.capturing():
            w["bvh"].launches += 1
            raise RuntimeError("capture refused")
    assert w["bvh"].launches == 2 and tally.per_replay == {"bvh": 1}


def test_launch_wrappers_name_every_counting_kernel():
    found = graphs.launch_wrappers()
    assert {"colored", "fused", "bvh", "brute", "raster", "groups",
            "tonemap", "blur", "shade_hit", "shade_next"} <= set(found)
    assert all(isinstance(w.launches, int) for w in found.values())


@dataclass
class _Inner:
    a: torch.Tensor
    b: Optional[torch.Tensor] = None
    scale: float = 1.0


def test_trees_flatten_and_come_back_whole():
    x, y, z = torch.ones(2), torch.zeros(3), torch.arange(4)
    tree = ((_Inner(x, None, 2.5), [y, "s", 3]), {"k": z, "n": None})
    leaves = []
    spec = graphs.flatten(tree, leaves)
    assert len(leaves) == 3 and leaves[0] is x
    back = graphs.unflatten(spec, leaves)
    assert back[0][0].a is x and back[0][0].b is None
    assert back[0][0].scale == 2.5 and back[0][1] == [y, "s", 3]
    assert back[1]["k"] is z and back[1]["n"] is None
    # The key holds the leaves' shapes and the other values, not the data.
    key = graphs._key(spec, leaves)
    other = graphs._key(graphs.flatten(
        ((_Inner(x + 1, None, 2.5), [y, "s", 3]), {"k": z, "n": None}), []),
        leaves)
    assert key == other
    assert key != graphs._key(graphs.flatten(
        ((_Inner(x, None, 3.0), [y, "s", 3]), {"k": z, "n": None}), []),
        leaves)


def test_graphed_runs_cpu_calls_eagerly():
    calls = []

    def fn(v, s=1.0):
        calls.append(1)
        return {"out": v * s}

    g = graphs.Graphed(fn)
    for k in range(3):
        assert torch.equal(g(torch.full((2,), float(k)), s=2.0)["out"],
                           torch.full((2,), 2.0 * k))
    assert len(calls) == 3 and g.captures == 0 and g.replays == 0


def test_physics_runner_is_eager_on_the_cpu():
    """`_physics_runner` on CPU tensors: frames stepped eagerly, the same
    state as `physics_step` frame by frame, no graph kept."""
    from d3d12renderer_tpu_torch import entry
    from d3d12renderer_tpu_torch.physics.step import physics_step
    from d3d12renderer_tpu_torch.physics.types import PhysicsSettings

    world = entry.flythrough_world("cpu")
    settings = PhysicsSettings(solver_iterations=4)
    run = entry._physics_runner(world.arch, settings)
    got, _ = run(world.state, 2)
    want = world.state
    with torch.inference_mode():
        for _ in range(2):
            want, _ = physics_step(world.arch, want, settings,
                                   entry.PHYSICS_FRAME_DT)
    assert torch.equal(got.pos, want.pos) and torch.equal(got.vel, want.vel)
    assert run.graphs == {} and run.failed == {}
