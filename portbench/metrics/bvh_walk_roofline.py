"""Kernel #3's share of its roofline (`csrc/ray_trace.cu`
`ray_closest_hit_bvh`, closest and any hit): the least time of the bytes
the profiled frames' rays and bounce levels need (`work/bvh_walk.py`) over
the kernel's summed device time in those frames.  The rays are counted by
the reference on the checked frames' sampled pixels, not by the program:
its rays a pixel, times the frame's pixels and the profiled frames."""

from portbench.peaks import least_seconds
from portbench.work import bvh_walk

META = {"unit": "%", "better": "higher", "source": "device_trace",
        "layer": "kernels", "moves": "frame_ms"}
PATTERNS = ("ray_closest_hit_bvh",)


def read(run):
    per_pixel = run.counts.get("rays_per_pixel")
    if run.trace is None or not per_pixel:
        return None
    cfg = run.cell.config
    rays = per_pixel * cfg["width"] * cfg["height"] * run.trace.calls
    launches = run.trace.kernels(PATTERNS)
    if not launches:
        return None
    busy = sum(e - s for _, s, e in launches) / 1e6
    flop, bytes_moved = bvh_walk.work(run.cell.config, rays, run.trace.calls)
    return 100.0 * least_seconds(flop, bytes_moved) / busy
