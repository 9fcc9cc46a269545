"""The port's example scripts (`examples/torch_*.py`, one per script of
examples/) run on the CPU at tiny sizes through their `main(argv)`, their
outputs under `tmp_path`, each held to the invariants the JAX scripts are
checked by: the rollout's mean reward in
1-2.3 with finite obs and no falls in its first steps, the 1k drop above
the floor and bounded, the vehicle finite above its terrain, images
written with finite, non-constant pixels.  Sizes the scripts fix (their
cascades, the eval render) are cut through their module constants: the
plain ray query over a few thousand rows takes seconds per 10^5 rays on
the CPU."""

import numpy as np
import pytest
import torch

from torch_examples import image_ok, load, png_ok

torch.set_num_threads(1)


def test_loco_rollout():
    out = load("loco_rollout").main(["--batch", "4", "--steps", "5",
                                     "--device", "cpu"])
    assert len(out["rewards"]) == 5
    assert 1.0 <= float(np.mean(out["rewards"])) <= 2.3
    assert out["obs_finite"] and out["terminations"] == 0


def test_stack_drop_1k():
    out = load("stack_drop_1k").main(["--bodies", "27", "--steps", "50",
                                      "--iterations", "4", "--device",
                                      "cpu"])
    assert out["frames"] == 50
    assert out["min_height"] > -0.2 and out["max_abs"] < 100.0
    assert np.isfinite(out["mean_speed"])


def test_vehicle_terrain(tmp_path, monkeypatch):
    mod = load("vehicle_terrain")
    monkeypatch.setattr(mod, "RENDER_SIZE", 24)
    monkeypatch.setattr(mod, "RENDER_SPP", 1)
    png = tmp_path / "drive.png"
    out = mod.main(["--seconds", "0.05", "--device", "cpu", "--render",
                    str(png)])
    assert out["finite"] and out["clearance"] > 0.0
    assert np.isfinite(out["distance"])
    assert png_ok(png) and out["image"].shape == (24, 24, 3)


def test_render_scene(tmp_path):
    png = tmp_path / "render.png"
    out = load("render_scene").main(["--size", "24", "--spp", "1",
                                     "--device", "cpu", "--out", str(png)])
    assert png_ok(png) and image_ok(out["image"])


def test_render_scene_point_lights(tmp_path):
    png = tmp_path / "render.png"
    load("render_scene").main(["--size", "16", "--spp", "1", "--device",
                               "cpu", "--out", str(png), "--point-lights"])
    assert png_ok(png)


def test_raster_frame(tmp_path, monkeypatch):
    from d3d12renderer_tpu_torch.assets.image_io import load_exr

    mod = load("raster_frame")
    monkeypatch.setattr(mod, "SHADOW_RESOLUTION", 16)
    png, exr = tmp_path / "frame.png", tmp_path / "frame.exr"
    out = mod.main(["--width", "48", "--height", "32", "--frames", "2",
                    "--profile-stages", "--device", "cpu", "--out", str(png),
                    "--dump-exr", str(exr)])
    assert png_ok(png) and out["image"].shape == (32, 48, 3)
    assert out["hdr_finite"] and load_exr(str(exr)).shape[:2] == (32, 48)
    assert set(out["stage_ms"]) >= {"gbuffer", "effects", "post"}


def test_scripts_refuse_the_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load("render_scene").main(["--size", "8"])
