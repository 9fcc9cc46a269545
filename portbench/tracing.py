"""The profiled part of a traced run and its reduction: device operations
with their times, the union of their intervals (busy time), the idle gaps
between them and what the host was doing in each.

`torch.profiler` keeps only the device activities whose times fall inside
its session on the host's clock, so the profiled calls sit between two host
pauses of PAD_S.  Nothing is written to disk: the events are read from the
profiler in memory.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import List, Tuple

PAD_S = 0.05
# Device activities that are copies or fills, not kernels.
COPY_PREFIXES = ("Memcpy", "Memset")
# Host ops looked at, back from a gap, for the one that covers it.
HOST_LOOKBACK = 4000


@dataclass
class Trace:
    """Device operations and host ops of the profiled calls, in
    microseconds on one clock."""

    calls: int
    window_s: float                                   # host clock
    device_ops: List[Tuple[str, float, float]] = field(default_factory=list)
    host_ops: List[Tuple[str, float, float]] = field(default_factory=list)

    def kernels(self, patterns=None):
        """Device kernels (copies and fills left out), those whose name
        holds one of `patterns` where given."""
        return [op for op in self.device_ops
                if not op[0].startswith(COPY_PREFIXES)
                and (patterns is None or any(p in op[0] for p in patterns))]

    def busy_intervals(self):
        """The union of the device operations' intervals, sorted."""
        out = []
        for _, s, e in sorted(self.device_ops, key=lambda op: op[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def top_device_ops(self, n: int = 10):
        total = defaultdict(float)
        for name, s, e in self.device_ops:
            total[name] += (e - s) / 1e6
        return sorted(([k, v] for k, v in total.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10):
        """Idle time between device operations, summed by the innermost
        host op that covered the gap's middle ("python" where none did):
        of nested ops, the one that began last."""
        busy = self.busy_intervals()
        host = sorted(self.host_ops, key=lambda op: op[1])
        starts = [op[1] for op in host]
        total = defaultdict(float)
        for (_, a), (b, _) in zip(busy, busy[1:]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            name = "python"
            for k in range(bisect.bisect_right(starts, mid) - 1,
                           max(-1, bisect.bisect_right(starts, mid) - 1
                               - HOST_LOOKBACK), -1):
                if host[k][2] >= mid:
                    name = host[k][0]
                    break
            total[name] += (b - a) / 1e6
        return sorted(([k, v] for k, v in total.items()),
                      key=lambda kv: -kv[1])[:n]


def profile_calls(driver, first: int, calls: int, sync, sleep=time.sleep):
    """Run the driver's calls `first` .. `first + calls - 1` under
    `torch.profiler`, device
    activity only (the CUDA runtime's calls on the host side come with it;
    recording every host op too would slow the host's dispatch that the
    trace measures).  Returns (profiler, window_s): `reduce` reads the
    events once the run's window is over."""
    import torch

    act = torch.profiler.ProfilerActivity
    # A CPU-only build (the tests) has no device activity to record.
    with torch.profiler.profile(activities=[
            act.CUDA if torch.cuda.is_available() else act.CPU]) as prof:
        sleep(PAD_S)
        t0 = time.perf_counter()
        for i in range(first, first + calls):
            driver.call(i, mode="profiled")
        sync()
        window_s = time.perf_counter() - t0
        sleep(PAD_S)
    return prof, window_s


def reduce(prof, calls: int, window_s: float) -> Trace:
    """The profiled calls' device operations and host calls."""
    from torch.autograd import DeviceType

    trace = Trace(calls=calls, window_s=window_s)
    for ev in prof.events():
        span = (ev.name, float(ev.time_range.start), float(ev.time_range.end))
        if ev.device_type == DeviceType.CUDA:
            trace.device_ops.append(span)
        else:
            trace.host_ops.append(span)
    return trace
