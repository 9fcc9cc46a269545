"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3) at its 700 W limit:
float32 outside the tensor cores and HBM bandwidth (NVIDIA's data sheet)."""

FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flop: float, bytes_moved: float) -> float:
    """The least time the card could take: the larger of the operations
    over the fp32 peak and the bytes over the HBM peak."""
    return max(flop / FP32_FLOP_PER_S, bytes_moved / HBM_BYTES_PER_S)


def roofline_percent(run, patterns, work_per_launch):
    """A kernel's share of its roofline in the profiled calls: the least
    time of its launches' work over their summed device time, in percent.
    None where the trace holds no launch of it."""
    if run.trace is None:
        return None
    launches = run.trace.kernels(patterns)
    if not launches:
        return None
    busy = sum(e - s for _, s, e in launches) / 1e6
    flop, bytes_moved = work_per_launch(run)
    return 100.0 * len(launches) * least_seconds(flop, bytes_moved) / busy
