"""examples/torch_train_locomotion.py and examples/torch_flythrough.py on
the CPU through their `main(argv)` at tiny sizes, outputs under
`tmp_path`: training losses finite, checkpoints and `episodes.csv`
written, the eval render finite and non-constant; `--mesh 2` without
torchrun refused with how to launch it; the flythrough's GIF with one
finite, non-constant frame per filmed frame.  The eval render and the
flythrough's cascades are cut through module constants."""

import csv
import os

import numpy as np
import pytest
import torch

from torch_examples import image_ok, load, png_ok

torch.set_num_threads(1)


def test_train_locomotion(tmp_path, monkeypatch):
    mod = load("train_locomotion")
    monkeypatch.setattr(mod, "EVAL_SIZE", 16)
    monkeypatch.setattr(mod, "EVAL_SPP", 1)
    logdir, png = tmp_path / "loco", tmp_path / "eval.png"
    out = mod.main(["--iterations", "2", "--envs", "8", "--rollout", "4",
                    "--device", "cpu", "--logdir", str(logdir),
                    "--eval-render", str(png)])
    assert len(out["losses"]) == 2
    assert all(np.isfinite(v) for d in out["losses"] for v in d.values())
    ckpts = sorted(os.listdir(logdir / "checkpoints"))
    assert "best.bin" in ckpts and any(f.startswith("ckpt_") for f in ckpts)
    with open(logdir / "episodes.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0][0] == "timesteps" and len(rows) == 3
    assert png_ok(png) and out["image"].shape == (16, 16, 3)


def test_train_locomotion_mesh_needs_torchrun(tmp_path, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        load("train_locomotion").main(["--mesh", "2", "--device", "cpu",
                                       "--logdir", str(tmp_path)])


def test_flythrough(tmp_path, monkeypatch):
    from PIL import Image

    from d3d12renderer_tpu_torch import entry

    monkeypatch.setattr(entry, "FLYTHROUGH_SHADOW_RESOLUTION", 16)
    gif = tmp_path / "fly.gif"
    out = load("flythrough").main(["--size", "32", "--frames", "2",
                                   "--device", "cpu", "--out", str(gif)])
    assert len(out["frames"]) == 2 and all(image_ok(f)
                                           for f in out["frames"])
    with Image.open(gif) as im:
        assert im.n_frames == 2 and im.size == (32, 32)
    assert all(np.isfinite(out["heights"]))
