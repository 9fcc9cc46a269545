"""Host and device profiling: named blocks, stat counters, chrome-trace
export, CUDA-event timing and per-function roofline reports (counterpart of
``d3d12renderer_tpu/core/profiling.py``).

Reference: src/core/cpu_profiling.h:14 (RAII blocks into a lock-free event
ring, per-frame resolve into a block tree + flame chart, CPU_PROFILE_STAT
counters) and src/dx/dx_profiling.h:25 (GPU timestamps resolved per frame).
Here host blocks wrap Python orchestration; device timing brackets calls with
`torch.cuda.Event` pairs (the GPU-timestamp equivalent); deep per-kernel
profiles are `torch.profiler` sessions written as chrome traces.  Events
export as chrome://tracing JSON.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

import torch

_tls = threading.local()
_lock = threading.Lock()
_events: List[dict] = []       # chrome trace events
_frame_stats: Dict[str, float] = {}
_enabled = True


def set_enabled(on: bool):
    global _enabled
    _enabled = on


def _stack() -> List[str]:
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    return _tls.stack


@contextmanager
def profile_block(name: str):
    """Named timing block (reference: CPU_PROFILE_BLOCK)."""
    if not _enabled:
        yield
        return
    t0 = time.perf_counter_ns()
    _stack().append(name)
    try:
        yield
    finally:
        t1 = time.perf_counter_ns()
        _stack().pop()
        with _lock:
            _events.append({
                "name": name, "ph": "X",
                "ts": t0 / 1000.0, "dur": (t1 - t0) / 1000.0,
                "pid": 0, "tid": threading.get_ident() % 100000,
            })


def profile_stat(name: str, value: float):
    """Per-frame stat counter (reference: CPU_PROFILE_STAT)."""
    if _enabled:
        with _lock:
            _frame_stats[name] = _frame_stats.get(name, 0.0) + value


def resolve_frame() -> Dict[str, Any]:
    """Collect and clear this frame's events+stats (reference:
    cpuProfilingResolveTimeStamps at frame start, main.cpp:57)."""
    global _events, _frame_stats
    with _lock:
        ev, _events = _events, []
        st, _frame_stats = _frame_stats, {}
    tree = _build_tree(ev)
    return {"events": ev, "stats": st, "tree": tree}


def _build_tree(events: List[dict]) -> List[dict]:
    """Nest events into a block tree per thread (reference:
    profiling_internal.h:30-55)."""
    by_tid: Dict[int, List[dict]] = {}
    for e in sorted(events, key=lambda e: e["ts"]):
        by_tid.setdefault(e["tid"], []).append(e)
    roots = []
    for tid, evs in by_tid.items():
        stack: List[dict] = []
        for e in evs:
            node = {"name": e["name"], "ts": e["ts"], "dur": e["dur"],
                    "children": []}
            while stack and e["ts"] >= stack[-1]["ts"] + stack[-1]["dur"]:
                stack.pop()
            (stack[-1]["children"] if stack else roots).append(node)
            stack.append(node)
    return roots


def export_chrome_trace(path: str, frames: Optional[List[dict]] = None):
    """Write accumulated events as chrome://tracing / Perfetto JSON."""
    with _lock:
        ev = list(_events)
    if frames:
        for f in frames:
            ev.extend(f["events"])
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)


def _tensors(obj, out=None) -> List[torch.Tensor]:
    """Every tensor in `obj`: tensors, sequences, dicts and dataclasses."""
    out = [] if out is None else out
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _tensors(x, out)
    elif isinstance(obj, dict):
        for x in obj.values():
            _tensors(x, out)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _tensors(getattr(obj, f.name), out)
    return out


def _device_of(*objs) -> torch.device:
    for t in _tensors(list(objs)):
        return t.device
    return torch.device("cpu")


def _timed_calls(fn, args, kw, iters: int, device: torch.device) -> float:
    """Seconds for `iters` back-to-back calls: CUDA events on the card,
    the host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args, **kw)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kw)
    return time.perf_counter() - t0


def time_device(fn, *args, iters: int = 10, warmup: int = 1, **kw) -> float:
    """Steady-state seconds per call of `fn`: `torch.cuda.Event` pairs
    around `iters` calls when its inputs or outputs lie on the card (the
    GPU-timestamp equivalent), the host clock for CPU tensors."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kw)
    device = _device_of(args, kw, out)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return _timed_calls(fn, args, kw, iters, device) / iters


@contextmanager
def device_trace(log_dir: str, name: str = "trace.json"):
    """A `torch.profiler` session (the card's kernels with CUPTI where a
    card is present) written to `log_dir/name` as a chrome trace."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, name))


# Peaks for roofline utilization: the NVIDIA H100 SXM's HBM3 rate and
# fp32 (non-tensor-core) rate, as PERF.md's kernel bounds use them, for an
# NVIDIA H100 80GB HBM3 at 700.00 W (nvidia-smi --query-gpu=
# name,power.limit --format=csv,noheader).  A card set below 700 W runs
# slower under load; `kernel_report` reports the card it ran on.
PEAK_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PLATFORM_PEAKS = {
    "cuda": {"flops": 67e12, "hbm_gbps": 3350.0},
    "cpu": {"flops": 1e11, "hbm_gbps": 50.0},      # order of magnitude only
}


def card_name_and_power() -> Optional[str]:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`'s
    first line, or None without nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def _dispatch_floor(device: torch.device) -> float:
    """Seconds for an empty launch round trip on `device` (one tiny kernel
    and a synchronize on the card); cached per device."""
    key = str(device)
    if key not in _dispatch_floor._cache:
        x = torch.zeros(8, device=device)

        def tiny():
            y = x + 1.0
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            return y

        tiny()
        t0 = time.perf_counter()
        for _ in range(10):
            tiny()
        _dispatch_floor._cache[key] = (time.perf_counter() - t0) / 10
    return _dispatch_floor._cache[key]


_dispatch_floor._cache = {}


def kernel_report(fn, *args, iters: int = 10, warmup: int = 2, **kw) -> dict:
    """Per-function device timing + roofline: time the steady state (CUDA
    events on the card), and combine it with the work into achieved
    GFLOP/s, GB/s and utilization of the card's peaks.

    Both work figures are floors: `flops` counts what
    `torch.utils.flop_counter.FlopCounterMode` sees (matmuls,
    convolutions, attention; no elementwise work and nothing inside a
    hand-written kernel), and `bytes_accessed` the bytes of the function's
    tensor inputs and outputs, each read or written once.  `compile_s` is
    the first call's seconds (a kernel's first call builds or loads it).
    """
    from torch.utils.flop_counter import FlopCounterMode

    t0 = time.perf_counter()
    out = fn(*args, **kw)
    device = _device_of(args, kw, out)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    compile_s = time.perf_counter() - t0

    counter = FlopCounterMode(display=False)
    with counter:
        out = fn(*args, **kw)
    flops = float(counter.get_total_flops())
    bytes_accessed = float(sum(
        t.numel() * t.element_size()
        for t in _tensors([args, kw]) + _tensors(out)))

    for _ in range(warmup):
        fn(*args, **kw)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    # Auto-scale iterations until the window is long enough for the
    # launch overhead to amortize.
    done, elapsed = 0, 0.0
    while True:
        elapsed += _timed_calls(fn, args, kw, iters, device)
        done += iters
        if elapsed > 0.3 or done >= 1000:
            break
        iters = min(iters * 4, 1000 - done)
    wall_s = elapsed / done
    # Events time the card's queue, not the host's dispatch; on the CPU
    # subtract the dispatch floor, but never more than half the wall time.
    device_s = wall_s if device.type == "cuda" else (
        wall_s - min(_dispatch_floor(device), 0.5 * wall_s))
    peaks = PLATFORM_PEAKS.get(device.type, PLATFORM_PEAKS["cpu"])
    gflops = flops / device_s / 1e9
    gbps = bytes_accessed / device_s / 1e9
    return {
        "compile_s": compile_s,
        "wall_s_per_call": wall_s,
        "device_s_per_call": device_s,
        "flops": flops,
        "bytes_accessed": bytes_accessed,
        "achieved_gflops": gflops,
        "achieved_gbps": gbps,
        "flops_utilization": gflops * 1e9 / peaks["flops"],
        "hbm_utilization": gbps / peaks["hbm_gbps"],
        "platform": device.type,
        "card": (card_name_and_power() if device.type == "cuda" else None),
    }


def profile_kernels(named, iters: int = 10) -> dict:
    """kernel_report over {name: (fn, args)}; records each as a profile stat
    and returns {name: report}."""
    reports = {}
    for name, (fn, fargs) in named.items():
        rep = kernel_report(fn, *fargs, iters=iters)
        reports[name] = rep
        profile_stat(f"kernel/{name}/device_ms",
                     rep["device_s_per_call"] * 1e3)
    return reports
