"""examples/torch_showcase.py on the CPU through its `main(argv)`, the
world cut (`models.world.WorldConfig`: a 17 x 17 map, 8 blades a side, maps
of 16^2 in a 64 atlas, one probe update of 4 rays, an 8^2 cubemap, one
fire step), two physics frames with the impact audio, the HDR sky from a
copy of examples/data/studio.hdr under `tmp_path` (the image cache writes
beside its source): the script's counts printed, the PNG and the WAV
written."""

import functools
import shutil

import torch

from torch_examples import image_ok, load, png_ok

torch.set_num_threads(1)


def test_showcase(tmp_path, monkeypatch):
    from d3d12renderer_tpu_torch.models import world

    monkeypatch.setattr(world, "WorldConfig", functools.partial(
        world.WorldConfig, resolution=17, grass_per_side=8, atlas_size=64,
        sun_resolution=16, spot_resolution=16, point_resolution=16,
        probe_updates=1, probe_rays=4, envmap_face=8, fire_steps=1))
    hdr = tmp_path / "studio.hdr"
    shutil.copy(world.ENVMAP, hdr)
    png, wav = tmp_path / "showcase.png", tmp_path / "impacts.wav"
    out = load("showcase").main(["--size", "32", "--physics-steps", "2",
                                 "--device", "cpu", "--out", str(png),
                                 "--audio", str(wav), "--envmap", str(hdr)])
    assert png_ok(png) and image_ok(out["image"])
    c = out["counts"]
    assert c["triangles"] > 0 and c["trees"] >= 0 and c["visible_blades"] > 0
    # The sun's three cascades, the spot's map and the point light's.
    assert out["viewports"] == 5 and len(out["heights"]) == 6
    assert wav.exists() and out["audio"]["path"] == str(wav)
    assert c["envmap_peak"] > 1.0
