"""examples/torch_stack_drop.py on the CPU through its `main(argv)`: the
three boxes rest at ~0.5 / 1.5 / 2.5 m and the sphere at ~0.4 m after the
JAX script's default steps less 100 (the sphere is at rest by then; each
step's 30-iteration colored solve takes ~0.2 s on the CPU)."""

import numpy as np
import torch

from torch_examples import load

torch.set_num_threads(1)

STEPS = 300
RESTING = (0.5, 1.5, 2.5, 0.4)
TOL = 0.05


def test_stack_drop_rests():
    out = load("stack_drop").main(["--steps", str(STEPS), "--device", "cpu"])
    assert out["finite"]
    np.testing.assert_allclose(out["heights"], RESTING, rtol=0, atol=TOL)


def test_stack_drop_batched():
    """`--batch` copies the scene: every copy steps alike."""
    out = load("stack_drop").main(["--batch", "2", "--steps", "2",
                                   "--device", "cpu"])
    assert out["finite"] and len(out["heights"]) == 4
