"""Host time a frame waiting for the card: the `pt.sync` spans (the ray
kernels' error-word read) on the host's clock, over the profiled frames
(`portbench/spans.py`)."""

from portbench.spans import reader

META = {"unit": "ms", "better": "lower", "source": "host_clock",
        "layer": "path tracer", "moves": "frame_ms"}
read = reader("pt.sync_wait_ms")
