"""Run one cell of the port's benchmark once on the card(s) of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the compared numbers beside their limits as the last lines of
standard error, and one JSON result line as the last line of standard
output.  Exits non-zero, printing no result, without enough CUDA cards,
outside a checkout that holds the port, or when JAX or the JAX package was
loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PORT_ENTRY = ROOT / "d3d12renderer_tpu_torch" / "entry.py"
# Build and kernel caches at fixed places inside the checkout (`build/` is
# ignored by git): the kernel library builds under build/torch_kernels by
# itself.
CACHE_DIRS = {
    "D3D12TPU_TORCH_BVH_CACHE_DIR": "build/portbench/bvh",
    "TRITON_CACHE_DIR": "build/portbench/triton",
    "TORCH_EXTENSIONS_DIR": "build/portbench/torch_extensions",
}


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str, code: int) -> int:
    print(f"portbench: {msg}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    args = parse(argv)
    if not PORT_ENTRY.is_file():
        return fail(f"no port at {PORT_ENTRY.parent}: run from a checkout "
                    "of the repository", 2)
    for key, rel in CACHE_DIRS.items():
        os.environ[key] = str(ROOT / rel)
        Path(os.environ[key]).mkdir(parents=True, exist_ok=True)
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))

    from portbench import harness

    cell = harness.Cell.load(args.workload, args.seed, args.seconds,
                             bool(args.trace))
    import torch

    marks = [("imports", time.perf_counter())]
    chips = cell.workload["chips"]
    if not torch.cuda.is_available():
        return fail("no CUDA device", 3)
    if torch.cuda.device_count() < chips:
        return fail(f"{cell.name} needs {chips} cards, "
                    f"{torch.cuda.device_count()} present", 3)
    marks.append(("device count", time.perf_counter()))

    def device_info():
        torch.cuda.synchronize()
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips,
                "memory_peak_bytes": max(
                    torch.cuda.max_memory_allocated(i) for i in range(chips))}
        card = harness.card_description()
        if card:
            info["card"] = card
        return info

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    result = harness.execute(cell, T0, torch.cuda.synchronize, event,
                             device_info, marks)
    phases = result.pop("setup_phases")
    print("setup: " + ", ".join(f"{name} {s:.3f} s" for name, s in phases),
          file=sys.stderr)
    found = harness.forbidden_loaded(sys.modules)
    if found:
        return fail(f"loaded in this process: {', '.join(found)}", 4)
    for name, (value, limit) in result["checks"].items():
        print(f"check {name}: {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
