"""The reductions that several metrics share.  A metric's file gives its
`META` and binds `read` to one of these (or to its own function); a reader
that finds nothing to read returns None."""

from portbench.harness import percentile


def ms_per_unit(run):
    """The window's host time over the steps or frames completed in it."""
    return 1e3 * run.window_s / run.units if run.units else None


def interval_p95(run):
    """The 95th percentile of the window's intervals between consecutive
    calls' end events (the first from the window's start)."""
    return percentile(run.interval_ms, 95) if run.interval_ms else None


def launches(run):
    """Device kernels in the profiled calls (copies and fills left out)
    over the steps or frames they ran (`steps_per_call` of the traffic, 1
    where it gives none)."""
    if run.trace is None or not run.trace.calls:
        return None
    steps = run.trace.calls * run.cell.traffic.get("steps_per_call", 1)
    return len(run.trace.kernels()) / steps


def device_idle(run):
    """The share of the profiled calls' host window in which no operation
    ran on the device: 1 minus the union of the device operations'
    intervals."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)


def span_mean(name):
    """A reader of the mean of the program's span `name` over the traced
    run's calls that timed it."""
    def read(run):
        xs = run.spans.get(name, [])
        return sum(xs) / len(xs) if xs else None
    return read
