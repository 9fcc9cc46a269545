"""Kernel #3's share of its roofline on the game frame's cascades
(`csrc/ray_trace.cu` `ray_closest_hit_bvh`): the least time of the bytes
the cascades' rays and the frame's posed rows need (`work/cascade_walk.py`,
from the configuration) over the kernel's device time, summed over its
launches in the profiled frames."""

from portbench.peaks import roofline_percent
from portbench.work import cascade_walk

META = {"unit": "%", "better": "higher", "source": "device_trace",
        "layer": "kernels", "moves": "frame_ms"}
PATTERNS = ("ray_closest_hit_bvh",)


def read(run):
    return roofline_percent(run, PATTERNS,
                            lambda r: cascade_walk.work(r.cell.config))
