"""Kernel #2's share of its roofline (`csrc/fused_substep.cu`): the least
time of its launches' work (`work/fused_substep.py`, at the contact points
the reference found on the checked steps) over their summed device time in
the profiled calls."""

from portbench.peaks import roofline_percent
from portbench.work import fused_substep

META = {"unit": "%", "better": "higher", "source": "device_trace",
        "layer": "kernels", "moves": "env_steps_per_s"}
PATTERNS = ("fused_substep_kernel",)


def read(run):
    points = run.counts.get("contact_points")
    if points is None:
        return None
    return roofline_percent(
        run, PATTERNS,
        lambda r: fused_substep.work(r.cell.config, points))
