"""The SSR march kernel's share of its roofline (`csrc/ssr.cu`
`ssr_march_kernel`): the least time of the bytes one launch must move
(`work/ssr_march.py`, from the configuration) over the kernel's device
time, summed over its launches in the profiled frames."""

from portbench.peaks import roofline_percent
from portbench.work import ssr_march

META = {"unit": "%", "better": "higher", "source": "device_trace",
        "layer": "kernels", "moves": "frame_ms"}
PATTERNS = ("ssr_march_kernel",)


def read(run):
    return roofline_percent(run, PATTERNS,
                            lambda r: ssr_march.work(r.cell.config))
