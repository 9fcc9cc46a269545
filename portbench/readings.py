"""The readings a cell's limits are set from: the program's compared
numbers on many seeds, and the control's (the plain reference in a lower
precision in the program's place) on a few, in one process.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 [--seconds 3] [--dtype bfloat16]

Prints one JSON line per seed and side.  Not run by the benchmark's runs.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--faults", default="",
                   help="faults planted in the reference in the program's "
                        "place, on the control seeds (training cells)")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness
    from portbench.run import CACHE_DIRS

    for key, rel in CACHE_DIRS.items():
        os.environ[key] = str(ROOT / rel)
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 3

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    control_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    dtype = getattr(torch, args.dtype)
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = harness.Cell.load(args.workload, seed, args.seconds, False)
        driver = harness.load_driver(cell)
        run = harness.Run(cell)
        harness.run_window(driver, run, time.perf_counter(),
                           torch.cuda.synchronize, event)
        driver.free()
        t = time.perf_counter()
        gaps, checked = driver.check(run)
        print(json.dumps({"seed": seed, "side": "program", "checked": checked,
                          "calls": run.calls, "gaps": gaps,
                          "check_s": time.perf_counter() - t}), flush=True)
        if seed in control_seeds:
            t = time.perf_counter()
            ctrl = driver.control(run, dtype)
            print(json.dumps({"seed": seed, "side": f"control_{args.dtype}",
                              "gaps": ctrl,
                              "control_s": time.perf_counter() - t}),
                  flush=True)
            for fault in (f for f in args.faults.split(",") if f):
                t = time.perf_counter()
                print(json.dumps({"seed": seed, "side": f"fault_{fault}",
                                  "gaps": driver.fault(run, fault),
                                  "fault_s": time.perf_counter() - t}),
                      flush=True)
        del driver, run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
