"""Device idle time a frame while the host shades: the trace's idle gaps
whose middle falls in `pt.shade`'s self time on the host, once the spans
are on the trace's clock (`portbench/spans.py`)."""

from portbench.spans import reader

META = {"unit": "ms", "better": "lower", "source": "device_trace",
        "layer": "device", "moves": "frame_ms"}
read = reader("pt.shade_idle_ms")
