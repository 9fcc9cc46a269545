"""The benchmark's general part: it finds a cell's files by name, runs the
cell's driver through set-up, the measured window and the check, and
reduces what it saw to the cell's metrics.

A cell (`workloads/<cell>.json`) names its configuration
(`configs/<config>.json`), its traffic mix (`traffic/<traffic>.json`, whose
`driver` names `drivers/<driver>.py`), its end-to-end metrics
(`end_to_end/<name>.py`), its per-layer metrics (`metrics/<name>.py`) and
the limits of its check.  Every metric file is a reader: `META` (unit,
better, source; a per-layer one also layer and moves; an end-to-end one its
bound) and `read(run) -> value or None`.
"""

from __future__ import annotations

import importlib.util
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Modules that may not be loaded in the process that prints a result,
# compared by whole top-level name (the port's own name begins with the
# JAX package's).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "d3d12renderer_tpu")


def load_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    """`<kind>/<name>.py` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} reader named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_loaded(modules) -> List[str]:
    return sorted({m.split(".")[0] for m in modules
                   if m.split(".")[0] in FORBIDDEN_MODULES})


@dataclass
class Cell:
    """One cell as its files give it, with the run's arguments."""

    name: str
    workload: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"

    @classmethod
    def load(cls, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda") -> "Cell":
        workload = load_json("workloads", name)
        return cls(name, workload, load_json("configs", workload["config"]),
                   load_json("traffic", workload["traffic"]), seed, seconds,
                   trace, device)


@dataclass
class Run:
    """What a run saw, for the readers."""

    cell: Cell
    setup_s: float = 0.0
    setup_phases: List[tuple] = field(default_factory=list)  # (name, s)
    window_s: float = 0.0
    calls: int = 0
    units: int = 0                  # env steps, frames or iterations
    interval_ms: List[float] = field(default_factory=list)
    enqueue_ms: List[float] = field(default_factory=list)
    spans: Dict[str, List[float]] = field(default_factory=dict)
    counts: Dict[str, float] = field(default_factory=dict)
    trace: Optional[object] = None  # tracing.Trace of the profiled calls
    checked: dict = field(default_factory=dict)


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of `values`, linear between ranks."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    k = (len(xs) - 1) * q / 100.0
    lo = int(k)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


def run_window(driver, run: Run, t0: float, sync, event, sleep=time.sleep,
               marks=()):
    """Set-up, then the measured window: calls dispatched back to back, each
    call's end recorded by an event, at most `in_flight` calls ahead of the
    card where the traffic says so, one synchronisation at the end.  With
    `--trace 1` the window is followed by `trace_calls` calls that time the
    program's own spans (its stage or phase clocks, which wait for the card
    at the end of each call) and `trace_calls` calls under the profiler,
    last so that the profiler's hooks slow no other call; then the trace is
    read."""
    cell = run.cell
    traffic = cell.traffic
    in_flight = traffic.get("in_flight")
    marks = list(marks) + [("driver load", time.perf_counter())]
    driver.setup()
    sync()
    start = event()
    t_start = time.perf_counter()
    run.setup_s = t_start - t0
    marks += getattr(driver, "marks", []) + [("rest", t_start)]
    run.setup_phases = [(name, t - prev) for (name, t), prev
                        in zip(marks, [t0] + [t for _, t in marks])]
    ends = []
    i = 0
    deadline = t_start + cell.seconds
    while time.perf_counter() < deadline:
        h0 = time.perf_counter()
        driver.call(i)
        run.enqueue_ms.append(1e3 * (time.perf_counter() - h0))
        ends.append(event())
        if in_flight and len(ends) > in_flight:
            ends[-1 - in_flight].synchronize()
        i += 1
    sync()
    run.window_s = time.perf_counter() - t_start
    run.calls = i
    run.units = i * driver.units_per_call
    points = [start] + ends
    run.interval_ms = [a.elapsed_time(b) for a, b in zip(points, points[1:])]
    if cell.trace:
        from . import tracing

        calls = traffic["trace_calls"]
        for j in range(i, i + calls):
            driver.call(j, mode="spans")
        sync()
        prof, window_s = tracing.profile_calls(driver, i + calls, calls, sync,
                                               sleep)
        run.trace = tracing.reduce(prof, calls, window_s)


def read_metrics(run: Run, kind: str, wanted) -> Dict[str, dict]:
    """The cell's metrics of `kind` ("end_to_end" or "metrics"), each from
    its reader; a reader that finds nothing is left out."""
    out = {}
    for name in wanted:
        reader = load_module(kind, name)
        value = reader.read(run)
        if value is not None:
            out[name] = {"value": value, "unit": reader.META["unit"]}
    return out


def load_driver(cell: Cell):
    import importlib

    module = importlib.import_module(
        f"portbench.drivers.{cell.traffic['driver']}")
    return module.Driver(cell)


def card_description() -> Optional[str]:
    """nvidia-smi's `name, power.limit` of the first card, or None."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def execute(cell: Cell, t0: float, sync, event, device_info,
            marks=()) -> dict:
    """One run of `cell`: set-up, the window, the memory peak, the program
    freed, the check, the metrics.  `marks` are (phase, end time) pairs of
    the set-up before this call.  Returns the result line's dict, its
    set-up's phases and the compared numbers last."""
    driver = load_driver(cell)
    run = Run(cell)
    run_window(driver, run, t0, sync, event, marks=marks)
    run.spans = getattr(driver, "spans", {})
    device = device_info()
    driver.free()
    gaps, checked = driver.check(run)
    limits = cell.workload["limits"]
    checks = {k: {"value": gaps[k], "limit": limits[k]} for k in limits}
    failed_checks = [k for k, c in checks.items() if not c["value"] <= c["limit"]]
    run.checked = checks
    kind = "metrics" if cell.trace else "end_to_end"
    wanted = cell.workload["per_layer" if cell.trace else "end_to_end"]
    result = {
        "correct": checked > 0 and not failed_checks,
        "attempted": run.units,
        "failed": run.units if failed_checks or checked == 0 else 0,
        "metrics": read_metrics(run, kind, wanted),
        "device": device,
    }
    if cell.trace:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["setup_phases"] = run.setup_phases
    result["checks"] = {k: [c["value"], c["limit"]] for k, c in checks.items()}
    return result
