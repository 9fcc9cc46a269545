"""The port's own spans and counters in a traced path-traced run, put on
the device trace's clock.

The port records spans and counters (`d3d12renderer_tpu_torch/core/
profiling.py`) while a `torch.profiler` session runs, so the profiled calls
of a `--trace 1` run leave theirs in its recorder, and nothing else in the
run does.  `recorded()` reads them in the same process once the run is
over; a port without the recorder, or a run that recorded nothing, gives
None, and so does every reader below.

A span's times are Unix-time ns (`on_us` puts them in us from the first
span's start, which floats hold to the ns); `run.trace`'s are us from a
start that the trace does not keep.  `clock_offset` fixes that start from
the runtime calls a span is known to hold: each `pt.sync` span holds the
`cudaMemcpyAsync` and `cudaStreamSynchronize` of its error-word read, a
copy to the host, and the CUDA-only session records both calls and the
copy (`read_calls`; the frame's other reads fall outside the span).  Each
such call gives the offsets that put it inside its span; at the offsets
that hold the most calls, their intersection over the profiled frames is
the bracket, and its middle the offset.  A bracket wider than
MAX_BRACKET_US, or none, gives None.

The spans (`render/pathtracer.py`, `ops/ray_trace.py`): `pt.frame` >
`pt.camera`, `pt.bounce` > (`ray.trace` > `ray.regroup`, `ray.walk`) and
`pt.shade` > `ray.trace` (the shadow queries), `pt.accumulate`, `pt.sync`.
A point of the host's clock belongs to the innermost span holding it, so a
span's self time is its interval less its children's.
"""

from __future__ import annotations

import bisect
import sys
from collections import defaultdict

PORT_PROFILING = "d3d12renderer_tpu_torch.core.profiling"
# The runtime calls of a `pt.sync` span's error-word read (`.item()`).
SYNC_CALLS = ("cudaMemcpyAsync", "cudaStreamSynchronize")
# Host calls that launch a kernel (prefixes: cudaLaunchKernelExC too).
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")
MAX_BRACKET_US = 50.0


def recorded():
    """The port's `profiling.recorded()` (spans and counter sums), or None
    where the port has no recorder or recorded no span."""
    read = getattr(sys.modules.get(PORT_PROFILING), "recorded", None)
    if read is None:
        return None
    rec = read()
    return rec if rec["spans"] else None


def on_us(spans):
    """The spans with "t0" and "t1": their start and end in us from the
    first span's start."""
    ref = min(s["start_ns"] for s in spans)
    return [dict(s, t0=(s["start_ns"] - ref) / 1e3,
                 t1=(s["end_ns"] - ref) / 1e3) for s in spans]


def read_calls(trace):
    """The host calls of the trace's reads to the host: each
    `cudaMemcpyAsync` whose device copy (a `DtoH` memcpy) starts before it
    or the `cudaStreamSynchronize` right after it ends, and that
    synchronisation.  (Copies to the card and on the card take the same
    `cudaMemcpyAsync`, the first with a synchronisation of its own.)"""
    host = sorted((op for op in trace.host_ops if op[0] in SYNC_CALLS),
                  key=lambda op: op[1])
    copies = sorted(s for name, s, _ in trace.device_ops if "DtoH" in name)
    calls = []
    for i, (name, a, b) in enumerate(host):
        if name != SYNC_CALLS[0]:
            continue
        sync = (host[i + 1] if i + 1 < len(host)
                and host[i + 1][0] == SYNC_CALLS[1] else None)
        end = b if sync is None else max(b, sync[2])
        k = bisect.bisect_left(copies, a)
        if k < len(copies) and copies[k] <= end:
            calls.append((a, b))
            if sync is not None:
                calls.append(sync[1:])
    return calls


def clock_offset(spans, trace):
    """(offset, bracket width) in us, trace time = span time ("t0", "t1"
    of `on_us`) - offset, from the `pt.sync` spans and the trace's
    `read_calls`; None where no offset puts such a call inside every
    `pt.sync` span, where more than one stretch of offsets does, or where
    the bracket is wider than MAX_BRACKET_US."""
    syncs = [(s["t0"], s["t1"]) for s in spans if s["name"] == "pt.sync"]
    offsets = [(s0 - a, s1 - b, k) for k, (s0, s1) in enumerate(syncs)
               for a, b in read_calls(trace) if s0 - a <= s1 - b]
    if not syncs or not offsets:
        return None
    # Probe at every interval's ends and between them: of the offsets at
    # which every span holds a call, those at which most calls are held.
    xs = sorted({x for lo, hi, _ in offsets for x in (lo, hi)})
    probes = [p for a, b in zip(xs, xs[1:]) for p in (a, 0.5 * (a + b))]
    held = []
    for p in probes + xs[-1:]:
        inside = [k for lo, hi, k in offsets if lo <= p <= hi]
        held.append(len(inside) if len(set(inside)) == len(syncs) else 0)
    most = max(held)
    if not most:
        return None
    best = [i for i, n in enumerate(held) if n == most]
    if best[-1] - best[0] != len(best) - 1:
        return None                      # two stretches: no one offset
    mid = 0.5 * ((probes + xs[-1:])[best[0]] + (probes + xs[-1:])[best[-1]])
    inside = [(lo, hi) for lo, hi, _ in offsets if lo <= mid <= hi]
    lo = max(lo for lo, _ in inside)
    hi = min(hi for _, hi in inside)
    if hi - lo > MAX_BRACKET_US:
        return None
    return 0.5 * (lo + hi), hi - lo


class Innermost:
    """The innermost span holding a point of the spans' clock (`on_us`):
    of the spans holding it, the one that began last."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: s["t0"])
        self.starts = [s["t0"] for s in self.spans]

    def __call__(self, t):
        for k in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            if self.spans[k]["t1"] >= t:
                return self.spans[k]
        return None


def idle_by_span(spans, trace, offset):
    """Device idle time (us) between the trace's busy intervals, summed by
    the innermost span holding the gap's middle (None: no span)."""
    find = Innermost(spans)
    busy = trace.busy_intervals()
    out = defaultdict(float)
    for (_, a), (b, _) in zip(busy, busy[1:]):
        if b > a:
            span = find(0.5 * (a + b) + offset)
            out[None if span is None else span["name"]] += b - a
    return dict(out)


def launches_by_span(spans, trace, offset):
    """Kernel launch calls on the host, counted by the innermost span
    holding the call's start."""
    find = Innermost(spans)
    out = defaultdict(int)
    for name, a, _ in trace.host_ops:
        if name.startswith(LAUNCH_CALLS):
            span = find(a + offset)
            out[None if span is None else span["name"]] += 1
    return dict(out)


def _device_self_ms(spans, name, child):
    """Device ms of the `name` spans less their `child` children's; None
    where a span has no device time."""
    total = 0.0
    for i, s in enumerate(spans):
        if s["name"] != name:
            continue
        parts = [s["device_ms"]] + [c["device_ms"] for c in spans
                                    if c["parent"] == i
                                    and c["name"] == child]
        if None in parts:
            return None
        total += parts[0] - sum(parts[1:])
    return total


def measure(rec, trace):
    """The path-traced frame's stage metrics, per profiled frame, from the
    recorder's `rec` and the device trace (None: those of the trace left
    out); a metric with nothing to read is left out."""
    spans = on_us(rec["spans"])
    frames = sum(s["name"] == "pt.frame" for s in spans)
    if not frames:
        return {}
    out = {}
    shade = _device_self_ms(spans, "pt.shade", "ray.trace")
    if shade is not None and any(s["name"] == "pt.shade" for s in spans):
        out["pt.shade_ms"] = shade / frames
    regroup = [s["device_ms"] for s in spans if s["name"] == "ray.regroup"]
    if regroup and None not in regroup:
        out["pt.regroup_ms"] = sum(regroup) / frames
    sync = [s["host_ms"] for s in spans if s["name"] == "pt.sync"]
    if sync:
        out["pt.sync_wait_ms"] = sum(sync) / frames
    rows = rec["counters"].get("pt.rows")
    if rows:
        out["pt.live_rows"] = (100.0 * rec["counters"].get("pt.live_rows", 0)
                               / rows)
    fixed = None if trace is None else clock_offset(spans, trace)
    if fixed is not None:
        offset = fixed[0]
        out["pt.shade_launches"] = launches_by_span(
            spans, trace, offset).get("pt.shade", 0) / frames
        out["pt.shade_idle_ms"] = idle_by_span(
            spans, trace, offset).get("pt.shade", 0.0) / 1e3 / frames
    return out


def reader(name):
    """`read(run)` of the metric `name` of `measure`."""
    def read(run):
        rec = recorded()
        return None if rec is None else measure(rec, run.trace).get(name)
    return read
