"""The game-frame cell (`flythrough_1080p.frame`) on the CPU at a tiny
size, the port's plain versions in place of its kernels: the run end to end
and correct, its traced metrics, the reference's physics against the
port's plain physics on seeded pile states, and the planted faults that
must come out not correct."""

import copy
import time

import pytest
import torch

from portbench import harness

from .tiny import HostEvent

CELL = "flythrough_1080p.frame"
# The plain walk on the CPU tests every cascade ray against every row: the
# cascades are cut to 8^2 and the frame to 64^2 (the bloom's pyramid needs
# a side of 32).
TINY = {"config": {"width": 64, "height": 64},
        "raster": {"cascade_resolution": 8},
        "physics": {"settle_frames": 2},
        "traffic": {"warmup_calls": 1, "check_from": 0, "check_to": 2,
                    "checked_calls": 2, "texel_grid": 4, "trace_calls": 1}}


def tiny_cell(seed=3, trace=False):
    cell = harness.Cell.load(CELL, seed, 0.5, trace, device="cpu")
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.config.update(TINY["config"])
    cell.config["raster"].update(TINY["raster"])
    cell.config["physics"].update(TINY["physics"])
    cell.traffic.update(TINY["traffic"])
    return cell


def run_driver(cell):
    """Set-up and the window through the harness; the driver kept for the
    checks (`harness.execute` without the check)."""
    driver = harness.load_driver(cell)
    run = harness.Run(cell)
    harness.run_window(driver, run, time.perf_counter(), lambda: None,
                       HostEvent)
    run.spans = driver.spans
    driver.free()
    return driver, run


@pytest.fixture(scope="module")
def driven():
    return run_driver(tiny_cell())


def test_cell_is_correct_on_the_cpu():
    cell = tiny_cell(seed=2**31 + 11)
    result = harness.execute(cell, time.perf_counter(), lambda: None,
                             HostEvent, lambda: {"platform": "cpu"})
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"frame_ms", "frame_ms_p95", "setup_s"}
    assert list(result)[-1] == "checks"


def test_traced_cell_reports_its_span_metrics_on_the_cpu():
    result = harness.execute(tiny_cell(trace=True), time.perf_counter(),
                             lambda: None, HostEvent,
                             lambda: {"platform": "cpu"})
    assert result["correct"], result["checks"]
    got = result["metrics"]
    # No device trace on the CPU: the launch, idle and roofline readers
    # find nothing; the spans and the counter are the program's.
    for name in ("phys.frame_ms", "shadow.cascades_ms", "phys.contact_rows"):
        assert name in got, got
    assert got["phys.frame_ms"]["value"] > 0


def test_checked_frames_are_kept_whole(driven):
    driver, run = driven
    assert driver.kept and driver.kept[0]["call"] == 0
    kept = driver.kept[0]
    assert kept["ldr"].shape == (64, 64, 3)
    assert kept["shadow_maps"]["depth"].shape == (3, 8, 8)
    assert kept["triangles"]["tri_v0"].shape == (2560, 3)
    gaps, checked = driver.check(run)
    assert checked == len(driver.kept)
    assert gaps["pose_gap"] < 1e-5 and gaps["vel_gap"] < 1e-4, gaps
    assert gaps["pixels_off"] == 0.0 and gaps["shadow_texels_off"] == 0.0


@pytest.mark.parametrize("fault", ["pose", "cascade", "pixels"])
def test_planted_faults_come_out_not_correct(driven, fault):
    """A body's pose nudged by 1e-2, a block of a cascade's texels moved,
    a block of pixels altered: each fails its limit."""
    driver, run = driven
    limits = driver.cell.workload["limits"]
    saved = driver.kept
    driver.kept = [copy.deepcopy(k) for k in saved]
    try:
        k = driver.kept[-1]
        if fault == "pose":
            k["after"]["pos"][0, 3, 0] += 1e-2
            name = "pose_gap"
        elif fault == "cascade":
            k["shadow_maps"]["depth"][1, :4, :4] += 1.0
            name = "shadow_texels_off"
        else:
            k["ldr"][:16, :16] = 1.0 - k["ldr"][:16, :16]
            name = "pixels_off"
        gaps, _ = driver.check(run)
    finally:
        driver.kept = saved
    assert gaps[name] > limits[name], (name, gaps)


def _packed(state, seed):
    """The pile's 18 bodies packed into a 3 x 3 x 2 grid 0.66 m apart on the
    plane (neighbours touching or 4 cm into each other), turned by small
    seeded rotations and moving: plane and pair rows active at once."""
    g = torch.Generator().manual_seed(seed)
    idx = torch.arange(18)
    pos = torch.stack([(idx % 3 - 1) * 0.66, 0.33 + (idx // 9) * 0.66,
                       (idx // 3 % 3 - 1) * 0.66], -1).float()
    rot = torch.cat([0.05 * torch.randn(18, 3, generator=g),
                     torch.ones(18, 1)], -1)
    rot = rot / rot.norm(dim=-1, keepdim=True)
    return state.replace(pos=pos[None], rot=rot[None],
                         vel=0.3 * torch.randn(1, 18, 3, generator=g),
                         omega=0.3 * torch.randn(1, 18, 3, generator=g))


@pytest.mark.parametrize("seed", [0, 5, 2**31 + 3])
def test_reference_physics_matches_the_port_plain(seed):
    """One frame of the seeded pile packed into contact (`_packed`): the
    reference's contact rows and its frame against the port's plain step
    (`solver_backend="plain"`), and the reference's archetype and colors
    equal to the builder's."""
    from d3d12renderer_tpu_torch import entry
    from d3d12renderer_tpu_torch.physics import collide, step
    from d3d12renderer_tpu_torch.physics.types import PhysicsSettings

    from portbench.reference import game

    cfg = harness.load_json("configs", "flythrough_1080p")
    world = entry.flythrough_world("cpu", pile_seed=seed)
    plain = PhysicsSettings(solver_backend="plain")
    arch = game.pile_archetype(cfg, seed, "cpu")
    assert [c.tolist() for c in arch.contact_color_indices] == [
        c.tolist() for c in world.arch.contact_color_indices]
    for f in ("inv_mass", "inv_inertia", "col_size", "col_type"):
        assert torch.equal(getattr(arch, f), getattr(world.arch, f)), f
    state = _packed(world.state, seed)
    with torch.inference_mode():
        port, _ = step.physics_step(world.arch, state, plain, 1 / 60, 2)
        port_rows = collide.generate_contacts(world.arch, state)
    bodies = {f: getattr(state, f).clone() for f in game.BODY_FIELDS}
    ref_state = game.physics_frame(arch, bodies, cfg)[0]
    ref_rows = game.generate_contacts(arch, state)
    assert torch.equal(ref_rows.active, port_rows.active)
    assert int(ref_rows.active[:, 18:].sum()) > 10     # pair rows touch
    for f in ("depth", "normal", "point"):
        torch.testing.assert_close(getattr(ref_rows, f),
                                   getattr(port_rows, f), rtol=0, atol=1e-6)
    gaps = game.body_gaps({f: getattr(port, f) for f in game.BODY_FIELDS},
                          ref_state)
    assert gaps["pose_gap"] < 1e-5 and gaps["vel_gap"] < 1e-4, gaps
