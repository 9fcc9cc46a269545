"""Kernel launch calls a frame in the path tracer's shading: the trace's
`cudaLaunchKernel` host calls that fall in `pt.shade`'s self time, once
the spans are on the trace's clock (`portbench/spans.py`)."""

from portbench.spans import reader

META = {"unit": "launches/frame", "better": "lower",
        "source": "device_trace", "layer": "path tracer",
        "moves": "frame_ms"}
read = reader("pt.shade_launches")
