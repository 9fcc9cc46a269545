"""The share of the bounce closest-hit queries' rows that are alive: 100 x
the `pt.live_rows` counter over `pt.rows` (R rows a bounce after the
first), over the profiled frames (`portbench/spans.py`)."""

from portbench.spans import reader

META = {"unit": "%", "better": "higher", "source": "program_counter",
        "layer": "path tracer", "moves": "frame_ms"}
read = reader("pt.live_rows")
