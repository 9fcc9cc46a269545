"""Host and device profiling: the port's span and counter recorder,
chrome-trace export, `torch.profiler` sessions and per-function roofline
reports (counterpart of ``d3d12renderer_tpu/core/profiling.py``).

Reference: src/core/cpu_profiling.h:14 (RAII blocks into a lock-free event
ring, per-frame resolve into a block tree + flame chart, CPU_PROFILE_STAT
counters) and src/dx/dx_profiling.h:25 (GPU timestamps resolved per frame).

The recorder.  `profile_block(name)` is a span, a `with` block: its name,
its start and end in Unix-time nanoseconds (`time.time_ns()`, the clock of
`torch.profiler`'s events), its parent span, and a frame id that every
span under one root span shares.  Opened with `device=True` it also
records a pair of CUDA events on the current stream (the GPU-timestamp
equivalent), resolved with one wait when the spans are read, never inside
a frame.  `profile_stat(name, value)` is a counter: the value is kept as
given, a 0-d device tensor without a sync, and summed when read.

It records only after `set_enabled(True)` or while a `torch.profiler`
session runs (any activity set), so a profiled call gets its spans
unasked.  Off, the default, `profile_block` returns one shared no-op
context object (no allocation, no event) and `profile_stat` returns at
once.  Spans go into a bounded in-memory buffer (`MAX_SPANS`, the oldest
dropped first); nothing is written while recording.  `recorded()` reads
the spans and counter sums and leaves them; `resolve_frame()` takes them
(block tree and stats); `export_chrome_trace()` writes them as
chrome://tracing JSON, device ms among each span's args.  `Stages` times
the consecutive stages of one call on such spans whether or not the
recorder is on (`render_frame(profile_stages=True)`,
`train_iteration(profile_phases=True)`).
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import json
import os
import subprocess
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

import torch
from torch.autograd import profiler as _torch_profiler

# Spans kept at most, the oldest dropped first (a path-traced frame of the
# atrium at depth 3 records 40), and values a counter keeps before they are
# folded into one.
MAX_SPANS = 1 << 16

_tls = threading.local()
_lock = threading.Lock()
_spans: collections.deque = collections.deque(maxlen=MAX_SPANS)
_counters: Dict[str, list] = {}
_frame_ids = itertools.count()
_enabled = False


def set_enabled(on: bool):
    """Record from now on (True), or only while a `torch.profiler` session
    runs (False, the default)."""
    global _enabled
    _enabled = on


def _stack() -> list:
    try:
        return _tls.stack
    except AttributeError:
        _tls.stack = []
        return _tls.stack


class _NoSpan:
    """What `profile_block` returns while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class Span:
    """One recorded block (see the module's docstring)."""

    __slots__ = ("name", "attrs", "kept", "parent", "frame", "tid",
                 "start_ns", "end_ns", "events", "device_ms")

    def __init__(self, name: str, device: bool, attrs: Optional[dict],
                 kept: bool):
        self.name, self.attrs, self.kept = name, attrs, kept
        self.parent = self.frame = self.end_ns = self.device_ms = None
        self.events = ((torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                       if device else None)

    def __enter__(self):
        self.start_ns = time.time_ns()
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.frame = (next(_frame_ids) if self.parent is None
                      else self.parent.frame)
        self.tid = threading.get_ident()
        stack.append(self)
        if self.kept:
            with _lock:
                _spans.append(self)
        if self.events is not None:
            self.events[0].record()
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
        _stack().pop()
        self.end_ns = time.time_ns()
        return False

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


def profile_block(name: str, device: bool = False,
                  attrs: Optional[dict] = None, force: bool = False):
    """A span named `name` (reference: CPU_PROFILE_BLOCK): a `with` block
    whose value is its `Span`.  `device`: also time it on the card with a
    pair of CUDA events (pass whether the block's work is on a CUDA
    device).  `attrs`: values kept with it (its chrome-trace args).
    `force`: make the span even while the recorder is off, for the caller
    alone; it joins the buffer only while the recorder is on."""
    recording = _enabled or _torch_profiler._is_profiler_enabled
    if recording or force:
        return Span(name, device, attrs, recording)
    return _NO_SPAN


def profile_stat(name: str, value):
    """Adds `value`, a number or a 0-d tensor kept as it is (no sync), to
    the counter `name` (reference: CPU_PROFILE_STAT)."""
    if _enabled or _torch_profiler._is_profiler_enabled:
        with _lock:
            values = _counters.setdefault(name, [])
            values.append(value)
            if len(values) > MAX_SPANS:
                values[:] = _fold(values)


def _fold(values) -> list:
    """`values` as one number and one 0-d tensor per device (launches, but
    no sync)."""
    numbers = [v for v in values if not isinstance(v, torch.Tensor)]
    by_device: Dict[torch.device, list] = {}
    for v in values:
        if isinstance(v, torch.Tensor):
            by_device.setdefault(v.device, []).append(
                v.reshape(()).to(torch.float64))
    return [sum(numbers)] + [torch.stack(ts).sum()
                             for ts in by_device.values()]


def _sum(values):
    """A counter's sum; an int where every value is an integer."""
    total = 0
    for v in _fold(values):
        total += v.item() if isinstance(v, torch.Tensor) else v
    integral = all(not v.is_floating_point() if isinstance(v, torch.Tensor)
                   else isinstance(v, int) for v in values)
    return int(total) if integral else total


def _resolve(spans):
    """Each span's device ms from its events: one wait for the card (the
    events after the first are done by then), then the events freed."""
    for s in spans:
        events = s.events
        if events is not None:
            events[1].synchronize()
            s.device_ms = events[0].elapsed_time(events[1])
            s.events = None


def _closed() -> list:
    with _lock:
        return [s for s in _spans if s.end_ns is not None]


def _describe(spans) -> List[dict]:
    _resolve(spans)
    index = {id(s): i for i, s in enumerate(spans)}
    return [{"name": s.name, "start_ns": s.start_ns, "end_ns": s.end_ns,
             "host_ms": s.host_ms, "device_ms": s.device_ms,
             "parent": None if s.parent is None else index.get(id(s.parent)),
             "frame": s.frame, "tid": s.tid, "attrs": dict(s.attrs or {})}
            for s in spans]


def recorded() -> Dict[str, Any]:
    """The closed spans and the counter sums, left in place:
    {"spans": [{name, start_ns, end_ns, host_ms, device_ms (None without
    events), parent (its index in the list; None for a root or a parent
    no longer kept), frame, tid, attrs}], "counters": {name: sum}}."""
    spans = _closed()
    with _lock:
        counters = {k: list(v) for k, v in _counters.items()}
    return {"spans": _describe(spans),
            "counters": {k: _sum(v) for k, v in counters.items()}}


def _chrome_events(described) -> List[dict]:
    events = []
    for d in described:
        args = dict(d["attrs"], frame=d["frame"])
        if d["device_ms"] is not None:
            args["device_ms"] = d["device_ms"]
        events.append({"name": d["name"], "ph": "X",
                       "ts": d["start_ns"] / 1e3,
                       "dur": (d["end_ns"] - d["start_ns"]) / 1e3,
                       "pid": 0, "tid": d["tid"] % 100000, "args": args})
    return events


def _tree(described) -> List[dict]:
    """The block tree from the spans' parents (reference:
    profiling_internal.h:30-55); a parent precedes its children."""
    nodes = [{"name": d["name"], "ts": d["start_ns"] / 1e3,
              "dur": (d["end_ns"] - d["start_ns"]) / 1e3, "children": []}
             for d in described]
    roots = []
    for d, node in zip(described, nodes):
        (roots if d["parent"] is None
         else nodes[d["parent"]]["children"]).append(node)
    return roots


def resolve_frame() -> Dict[str, Any]:
    """Take the closed spans and the counters (reference:
    cpuProfilingResolveTimeStamps at frame start, main.cpp:57):
    {"events": chrome events, "stats": counter sums, "tree": block tree}."""
    with _lock:
        spans = [s for s in _spans if s.end_ns is not None]
        still_open = [s for s in _spans if s.end_ns is None]
        _spans.clear()
        _spans.extend(still_open)
        counters = dict(_counters)
        _counters.clear()
    described = _describe(spans)
    return {"events": _chrome_events(described),
            "stats": {k: _sum(v) for k, v in counters.items()},
            "tree": _tree(described)}


def export_chrome_trace(path: str, frames: Optional[List[dict]] = None):
    """Write the closed spans (left in place) and the events of `frames`
    (`resolve_frame()`'s) as chrome://tracing / Perfetto JSON."""
    events = _chrome_events(_describe(_closed()))
    for f in frames or ():
        events.extend(f["events"])
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)


class Stages:
    """Device-timed spans `<prefix>.<stage>` around the consecutive stages
    of one call, made for the caller while `on` (and recorded like any
    span while the recorder is on).  `ms()`: {stage: ms}, CUDA-event time
    on the card, host time on the CPU, after one wait."""

    def __init__(self, prefix: str, on: bool, device: torch.device):
        self.prefix, self.on = prefix, on
        self.cuda = device.type == "cuda"
        self.spans: List[Span] = []

    def __call__(self, stage: str):
        span = profile_block(f"{self.prefix}.{stage}", device=self.cuda,
                             force=self.on)
        if self.on:
            self.spans.append(span)
        return span

    def ms(self) -> Dict[str, float]:
        _resolve(self.spans)
        cut = len(self.prefix) + 1
        return {s.name[cut:]: s.host_ms if s.device_ms is None
                else s.device_ms for s in self.spans}


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


# Bounds of the hand-written kernels.  `kernel_report`'s FlopCounterMode
# sees nothing inside a kernel launched through ctypes, so a kernel's
# bound (`bound`: the larger of its bytes over the HBM rate and its
# operations over the fp32 peak, at the table's rates for one H100 SXM at
# the 700 W limit) counts its work from these per-test operation counts and
# the run's inputs (`group_bound`, `solve_flop`), and
# `instruction_floor_ms` gives the least time of an instruction count.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# Its SMs and the fp32 lanes of each.
H100_SMS, LANES_PER_SM = 132, 128
# Float operations per row solve, counted from csrc/solver_rows.cuh (a
# multiply and an add count 2; min/max clamps count 1): the ball part 114,
# distance 62, fixed 174 (rotation 60 + ball), hinge 250 (motor, limit and
# rotation parts + ball), cone-twist 255 (four 1-D parts + ball); a contact
# point against the static world 85 (friction then normal).
# A slider row 275 (motor 32, limit 57, rotation 57, position 129).  A
# contact table whose A side is dynamic somewhere (collider-pair rows) runs
# the A side for every point: 48 more (the A lever arm's cross product and
# add, and the A velocity updates, for friction and normal).
ROW_FLOP = {"ball": 114, "distance": 62, "fixed": 174, "hinge": 250,
            "cone_twist": 255, "slider": 275}
CONTACT_POINT_FLOP = 85
CONTACT_POINT_A_FLOP = 48
# The ray plane test (csrc/ray_plane.cuh): 6 three-term dots (5 each), the
# quotient, u, v and the accept terms = 42; a slab test of a node box: 6
# subtractions, 6 products and 12 min/max = 24.  Of these, o.n, n_off - o.n
# and the origin terms o.e1p + e1_off, o.e2p + e2_off (18) and the slab's
# lo - o, hi - o (6) depend on the row or node and the ray's origin only:
# rays that share an origin need them once per row or node.
PLANE_TEST_FLOP = 42
PLANE_ORIGIN_FLOP = 18
BOX_TEST_FLOP = 24
BOX_ORIGIN_FLOP = 6
# The raster kernel's test of one (pair, pixel) (csrc/raster.cu): 4
# two-term dots with an offset (4 operations each) and 6 compares = 22.
# The tonemap: exposure, the curve (8), its quotient and clamps = 14.
RASTER_PAIR_FLOP = 22
TONEMAP_FLOP = 14


def bound(bytes_moved, flop):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the fp32 peak."""
    mem_ms = 1e3 * bytes_moved / HBM_BYTES_PER_S
    op_ms = 1e3 * flop / FP32_FLOP_PER_S
    return (mem_ms, "bytes") if mem_ms >= op_ms else (op_ms, "operations")


def group_bound(raster, tables, plan, q, jitter, width, height):
    """The group kernel's bound over one whole-frame launch: (bound_ms,
    bound_by, tests, tile_tests).  `raster` is the port's `ops.raster`
    module (passed in, so that this module loads alone by path).  `tests`
    are the (visit, band, row, pixel) tests any exact cull of a row per row
    band must run, the kernel's own granularity (`raster.group_rows_needed`
    given the final image q, PX // GROUP_BANDS pixels a band),
    RASTER_PAIR_FLOP each; the bytes read the planes, ranges and plan once
    and write (q, tri).  `tile_tests` counts at the tile's granularity for
    comparison: the (visit, triangle) tests of the visits whose bound
    exceeds the tile's least q, PX pixels each."""
    tests = raster.group_rows_needed(tables, plan, q, jitter, width,
                                     height) * (raster.PX // raster.GROUP_BANDS)
    least = raster.tile_min(q, width, height)
    must = plan.bound > least[plan.visit_tile]
    tile_tests = int(raster.visit_cover(
        tables, plan.visit_tile[must], plan.group[must], width).sum()) \
        * raster.PX
    bytes_moved = (tables.planes.numel() * 4 + tables.tri_tiles.numel() * 4
                   + plan.visits * 8 + plan.seg.numel() * 4
                   + plan.tiles.numel() * 4 + 8 + width * height * 8)
    return (*bound(bytes_moved, tests * RASTER_PAIR_FLOP), tests, tile_tests)


def instruction_floor_ms(tests, per_test, sm_mhz):
    """The least time of `tests` tests of `per_test` SASS instructions
    each when every lane of the card issues one a cycle at `sm_mhz`."""
    return 1e3 * tests * per_test / (H100_SMS * LANES_PER_SM * sm_mhz * 1e6)


def solve_flop(tables, batch, points, iterations):
    """Operations of one `iterations`-long solve: every joint row of every
    scene, and the active contact points (`points`, summed over scenes),
    with their A side where the contact table has one."""
    rows = sum(m.perm.shape[0] * ROW_FLOP[m.kind] for m in tables
               if m.kind != "contact")
    point_flop = CONTACT_POINT_FLOP + sum(
        CONTACT_POINT_A_FLOP for m in tables
        if m.kind == "contact" and not m.a_static)
    return iterations * (batch * rows + points * point_flop)


def ray_bound(rays, tests, boxes, origins, rows, nodes, plane_cols,
              node_cols):
    """The ray walk's bound: `tests` plane tests and `boxes` box tests of
    `rays` rays from `origins` distinct origins over `rows` plane rows of
    `plane_cols` floats and `nodes` nodes of `node_cols` floats, each
    origin-only term counted once per (origin, row or node) where rays
    share origins; each ray's origin, direction, t_max and (t, tri) read or
    written once."""
    flop = (tests * (PLANE_TEST_FLOP - PLANE_ORIGIN_FLOP)
            + min(tests, origins * rows) * PLANE_ORIGIN_FLOP
            + boxes * (BOX_TEST_FLOP - BOX_ORIGIN_FLOP)
            + min(boxes, origins * nodes) * BOX_ORIGIN_FLOP)
    return bound(rays * (12 + 12 + 4 + 4 + 4) + rows * 4 * plane_cols
                 + (nodes * 4 * node_cols if boxes else 0), flop)


def pair_band_q(raster, qp, col0, row0, jitter):
    """A plane's largest q over a row band of a tile: its q at the one
    corner sample the signs of (qx, qy) pick, as csrc/raster.cu computes
    it."""
    rows = raster.TILE_Y // raster.BANDS
    x = torch.where(qp[:, 0] >= 0, col0 + raster.TILE_X - 1, col0).to(
        torch.float32) + jitter[0]
    y = torch.where(qp[:, 1] >= 0, row0 + rows - 1, row0).to(
        torch.float32) + jitter[1]
    return (qp[:, 0] * x + qp[:, 1] * y) + qp[:, 2]


def pair_tests_needed(raster, planes, pair_tri, seg, q, jitter, width,
                      height) -> int:
    """The (pair, band) tests any exact cull of the pair kernel must run
    given the final image q: those whose largest q over the band exceeds
    the band's least final q."""
    rows = raster.TILE_Y // raster.BANDS
    ntx = width // raster.TILE_X
    least = q.reshape(height // rows, rows, ntx, raster.TILE_X).amin(
        dim=(1, 3))                                   # (band rows, ntx)
    pairs = int(seg[-1])                   # `bin_pairs` may list more slots
    tile = torch.repeat_interleave(
        torch.arange(seg.shape[0] - 1, device=q.device),
        (seg[1:] - seg[:-1]).long(), output_size=pairs)
    qp = planes[pair_tri[:pairs].long(), 9:12]
    needed = 0
    for band in range(raster.BANDS):
        band_row = tile // ntx * raster.BANDS + band
        needed += int((pair_band_q(raster, qp, tile % ntx * raster.TILE_X,
                                   band_row * rows, jitter)
                       > least[band_row, tile % ntx]).sum())
    return needed


def pair_bound(raster, planes, pairs, seg, needed, width, height):
    """The pair kernel's bound over one launch: the planes, pairs and tile
    segments read once, (q, tri, u, v) written; `needed` (pair, band)
    tests (`pair_tests_needed`) over their band's pixels."""
    return bound(planes.numel() * 4 + pairs * 4 + seg.numel() * 4 + 8
                 + width * height * 16,
                 needed * (raster.PX // raster.BANDS) * RASTER_PAIR_FLOP)


def shade_bytes(rays, live, table_rows, first, last, direct, lights, atlas,
                roulette):
    """(pt_shade_hit, pt_shade_next) bytes that one bounce's shading
    (csrc/pt_shade.cu) needs over `rays` rays of which `live` are alive at
    its start, each input read and each output written once, `table_rows`
    the distinct shading-table rows the bounce's hits touch.  A live ray in
    pt_shade_hit: t, tri, uv, origin and direction in (40), radiance,
    normal and p out (36); alive, throughput and radiance in after the
    first bounce (25); the sun's direction and t_max out (16); the light
    pick and sphere normal in, its direction and t_max out (36).  In
    pt_shade_next: tri, uv, normal, direction in (36); alive and throughput
    after the first bounce (13); radiance in and out and the sun's shadow
    hit (25); p, the light's draws and shadow hit (33); before the last
    bounce the three BRDF draws in, throughput, direction, alive and t_max
    out (41); the roulette's draw (4).  A dead ray needs only its alive
    byte read and its masks written: the shadow queries' t_max in
    pt_shade_hit (4 each), the next query's in pt_shade_next before the
    last bounce (4).  A table row: 15 floats in pt_shade_hit (normals,
    geometric normal, emission), 5 in pt_shade_next (albedo, roughness,
    metallic; the uvs and texture index too with an atlas)."""
    dead = rays - live
    hit = (76 + (0 if first else 25) + (16 if direct else 0)
           + (36 if lights else 0))
    nxt = (36 + (0 if first else 13) + (25 if direct else 0)
           + (33 if lights else 0) + (0 if last else 41)
           + (4 if roulette else 0))
    hit_dead = 1 + (4 if direct else 0) + (4 if direct and lights else 0)
    nxt_dead = 1 + (0 if last else 4)
    return (live * hit + dead * hit_dead + table_rows * 60,
            live * nxt + dead * nxt_dead + table_rows * (48 if atlas else 20))


def blur_work(numel, radius):
    """(bytes, operations) of one separable blur of `numel` floats: read
    and written once, a multiply-add per tap in each of the two passes."""
    return 2 * 4 * numel, numel * 2 * 2 * (2 * radius + 1)


def tonemap_bound(n):
    """The tonemap's bound over `n` floats: read and written once,
    TONEMAP_FLOP operations each."""
    return bound(2 * 4 * n, n * TONEMAP_FLOP)


def solve_bound(prep_numel, vel_numel, tables, batch, points, iterations):
    """The colored solve's bound: its packed prep read once, velocities and
    angular velocities in and out; `solve_flop`'s operations."""
    return bound(4 * (prep_numel + 4 * vel_numel),
                 solve_flop(tables, batch, points, iterations))


def env_step_bound(batch, bodies, action_size, state_size, tables, points,
                   iterations):
    """The fused env step's bound: the body state in and out, the action
    in, obs, reward and done out; the solve's operations at the step's
    active contact points (the narrowphase, prep and post stage left out:
    a lower bound)."""
    return bound(4 * batch * (2 * 19 * bodies + action_size + state_size
                              + 2),
                 solve_flop(tables, batch, points, iterations))
