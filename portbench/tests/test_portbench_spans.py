"""`portbench/spans.py` on a synthetic trace and synthetic spans with a
planted clock offset: the offset recovered from the `pt.sync` spans' sync
calls, the idle gaps and launch calls that fall in `pt.shade`'s self time
counted and no others, the device-timed and counted metrics, and None
where the bracket is too wide, where there is none, or where the port
recorded nothing."""

import types

import pytest

from portbench import spans as sp
from portbench.tracing import Trace

BASE_NS = 1_790_000_000_000_000_000      # a Unix time in ns
SHIFT_US = 777.25                        # trace time = span time + SHIFT
FRAME_US = 40_000


def span(name, t0, t1, parent=None, device_ms=None):
    return {"name": name, "start_ns": BASE_NS + int(t0 * 1e3),
            "end_ns": BASE_NS + int(t1 * 1e3), "host_ms": (t1 - t0) / 1e3,
            "device_ms": device_ms, "parent": parent, "frame": 0, "tid": 1,
            "attrs": {}}


def synthetic(slacks, skews=None):
    """One frame per (start slack, end slack) of its sync calls inside its
    `pt.sync` span, the frame's calls moved by its skew (us) on the
    trace's clock: spans, and a trace of kernels, sync and launch calls."""
    spans, host, device = [], [], []

    def add(*a, **k):
        spans.append(span(*a, **k))
        return len(spans) - 1

    for f, (first, last) in enumerate(slacks):
        skew = skews[f] if skews else 0.0
        t = f * FRAME_US
        root = add("pt.frame", t, t + 30_000)
        bounce = add("pt.bounce", t + 1_000, t + 20_000, root)
        trace = add("ray.trace", t + 1_000, t + 5_000, bounce, 1.0)
        add("ray.regroup", t + 1_100, t + 1_500, trace, 0.5)
        shade = add("pt.shade", t + 5_000, t + 19_000, bounce, 5.0)
        add("ray.trace", t + 10_000, t + 12_000, shade, 2.0)
        add("pt.sync", t + 25_000, t + 29_000, root)
        on_trace = t + SHIFT_US
        host += [("cudaMemcpyAsync", on_trace + skew + 25_000 + first,
                  on_trace + skew + 25_010 + first),
                 ("cudaStreamSynchronize", on_trace + skew + 25_020 + first,
                  on_trace + skew + 29_000 - last),
                 # in the shade's self time twice, in its shadow query, in
                 # the bounce's query: 2 of 4 count.
                 ("cudaLaunchKernel", on_trace + 6_000, on_trace + 6_005),
                 ("cudaLaunchKernel", on_trace + 15_000, on_trace + 15_005),
                 ("cudaLaunchKernel", on_trace + 11_000, on_trace + 11_005),
                 ("cudaLaunchKernel", on_trace + 2_000, on_trace + 2_005),
                 # a copy to the card, with its own sync, and one on it
                 ("cudaMemcpyAsync", on_trace + 3_000, on_trace + 3_004),
                 ("cudaStreamSynchronize", on_trace + 3_005, on_trace + 3_007),
                 ("cudaMemcpyAsync", on_trace + 16_000, on_trace + 16_004)]
        device += [("Memcpy DtoH (Device -> Pageable)",
                    on_trace + skew + 25_021 + first,
                    on_trace + skew + 25_022 + first),
                   ("Memcpy HtoD (Pageable -> Device)", on_trace + 3_001,
                    on_trace + 3_002)]
        # Idle gaps: [5600, 5800] and [11500, 13000] have their middles in
        # the shade's self time (1.7 ms); [10500, 11000] in its shadow
        # query; the gap to the next frame in no span.
        for a, b in ((100, 5_600), (5_800, 10_500), (11_000, 11_500),
                     (13_000, 26_000)):
            device.append(("kernel", on_trace + a, on_trace + b))
    trace = Trace(calls=len(slacks), window_s=1.0, device_ops=device,
                  host_ops=host)
    rec = {"spans": spans, "counters": {"pt.rows": 400, "pt.live_rows": 100}}
    return rec, trace


def test_offset_recovered_within_a_microsecond():
    rec, trace = synthetic([(0.5, 10.0), (10.0, 0.5), (5.0, 5.0)])
    offset, width = sp.clock_offset(sp.on_us(rec["spans"]), trace)
    assert offset == pytest.approx(-SHIFT_US, abs=1.0)
    assert width == pytest.approx(1.0, abs=1e-6)
    # The reads only: each frame's copy to the host and its sync.
    assert len(sp.read_calls(trace)) == 2 * 3


def test_metrics_count_only_the_shades_self_time():
    rec, trace = synthetic([(0.5, 10.0), (10.0, 0.5), (5.0, 5.0)])
    got = sp.measure(rec, trace)
    assert got["pt.shade_launches"] == 2
    assert got["pt.shade_idle_ms"] == pytest.approx(1.7)
    assert got["pt.shade_ms"] == pytest.approx(3.0)
    assert got["pt.regroup_ms"] == pytest.approx(0.5)
    assert got["pt.sync_wait_ms"] == pytest.approx(4.0)
    assert got["pt.live_rows"] == pytest.approx(25.0)
    spans = sp.on_us(rec["spans"])
    offset, _ = sp.clock_offset(spans, trace)
    idle = sp.idle_by_span(spans, trace, offset)
    assert idle["ray.trace"] == pytest.approx(3 * 500)
    assert idle[None] == pytest.approx(2 * 14_100)
    assert sp.launches_by_span(spans, trace, offset) == {"pt.shade": 6,
                                                         "ray.trace": 6}


@pytest.mark.parametrize("slacks, skews", [
    ([(60.0, 60.0), (60.0, 60.0)], None),          # a bracket 120 us wide
    ([(1.0, 1.0), (1.0, 1.0)], [0.0, 5_000.0]),    # none: clocks disagree
    ([(-1.0, -1.0), (1.0, 1.0)], None),            # none: calls too long
])
def test_no_offset_without_a_narrow_bracket(slacks, skews):
    rec, trace = synthetic(slacks, skews)
    assert sp.clock_offset(sp.on_us(rec["spans"]), trace) is None
    got = sp.measure(rec, trace)
    assert "pt.shade_launches" not in got and "pt.shade_idle_ms" not in got
    assert got["pt.shade_ms"] == pytest.approx(3.0)


def test_readers_find_nothing_without_the_recorder(monkeypatch):
    run = types.SimpleNamespace(trace=None)
    monkeypatch.setitem(__import__("sys").modules, sp.PORT_PROFILING,
                        types.ModuleType("profiling"))
    assert sp.recorded() is None and sp.reader("pt.shade_ms")(run) is None
    empty = types.ModuleType("profiling")
    empty.recorded = lambda: {"spans": [], "counters": {}}
    monkeypatch.setitem(__import__("sys").modules, sp.PORT_PROFILING, empty)
    assert sp.reader("pt.live_rows")(run) is None
    assert sp.measure({"spans": [span("x", 0, 1)], "counters": {}},
                      None) == {}
