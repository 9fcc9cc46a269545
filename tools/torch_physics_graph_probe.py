"""The physics runner's CUDA graph on one GPU: for the 1k-body stack drop,
the vehicle and the vehicle on terrain (`entry.stack_drop_entry`,
`vehicle_entry`, `vehicle_terrain_entry` at their defaults), the host time
of an eager frame (six calls of one frame), of the first call of six
frames (one eager frame, the capture, five replays) and of a replayed
frame (ten in one call); how far the replayed state lies from the eager
one, beside how far two eager runs lie apart (split_jacobi adds with float
atomics); and one profiled replay's kernels and device time.  Then
`chip_smoke.runtime_physics`, timed whole.

    python3 tools/torch_physics_graph_probe.py

Prints one line per measurement, after the card's name and power limit.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

EAGER_FRAMES, FIRST_CALL_FRAMES, REPLAY_FRAMES = 6, 6, 10


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this probe runs only on a GPU")
    import chip_smoke
    from d3d12renderer_tpu_torch import entry

    sync = torch.cuda.synchronize
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)

    def diffs(a, b):
        return {f: float((getattr(a, f) - getattr(b, f)).abs().max())
                for f in ("pos", "rot", "vel", "omega")}

    paths = (
        ("vehicle", lambda: entry.vehicle_entry(
            device="cuda", batch=8, throttle=chip_smoke.VEHICLE_THROTTLES)),
        ("stack1k", lambda: entry.stack_drop_entry(
            device="cuda", bodies=1000, batch=8)),
        ("vehicle_terrain", lambda: entry.vehicle_terrain_entry(
            device="cuda")))
    for name, make in paths:
        t0 = time.perf_counter()
        eager, parts = make()
        st0 = parts[-1]
        graphed, _ = make()
        eager2, _ = make()
        print(name, "set-up s", round(time.perf_counter() - t0, 2),
              flush=True)
        a = c = st0
        t0 = time.perf_counter()
        for _ in range(EAGER_FRAMES):
            a, _ = eager(a, 1)    # one frame a call: never captured
        sync()
        eager_s = (time.perf_counter() - t0) / EAGER_FRAMES
        for _ in range(EAGER_FRAMES):
            c, _ = eager2(c, 1)
        t0 = time.perf_counter()
        b, _ = graphed(st0, FIRST_CALL_FRAMES)
        sync()
        first_s = time.perf_counter() - t0
        print(name, "eager frame s", round(eager_s, 4),
              "first graphed call (eager + capture + replays) s",
              round(first_s, 3), "graph-eager", diffs(b, a), "eager-eager",
              diffs(c, a), flush=True)
        t0 = time.perf_counter()
        b2, _ = graphed(b, REPLAY_FRAMES)
        sync()
        print(name, "replay frame s",
              round((time.perf_counter() - t0) / REPLAY_FRAMES, 4),
              flush=True)
        kpf, dev_ms = chip_smoke._profiled(lambda n: graphed(b2, n))
        print(name, "profiled replay: kernels", kpf, "device ms",
              round(dev_ms, 3), flush=True)
        del eager, graphed, eager2
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    chip_smoke.runtime_physics(card)
    print("runtime_physics phase s", round(time.perf_counter() - t0, 1),
          flush=True)


if __name__ == "__main__":
    main()
