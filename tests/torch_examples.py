"""Loads the port's example scripts (`examples/torch_*.py`) by path for the
tests, as modules of their own, so that a test can cut a script's module
constants before it calls the script's `main(argv)`."""

import importlib.util
from pathlib import Path

import numpy as np

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def load(name: str):
    """examples/torch_<name>.py as a fresh module."""
    path = EXAMPLES / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def image_ok(arr) -> bool:
    """Finite, non-constant pixels."""
    arr = np.asarray(arr, np.float64)
    return bool(np.isfinite(arr).all()) and float(arr.std()) > 0.0


def png_ok(path) -> bool:
    from PIL import Image

    with Image.open(path) as im:
        return image_ok(np.asarray(im.convert("RGB")))
