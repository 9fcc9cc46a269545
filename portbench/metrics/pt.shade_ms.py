"""Device time of the path tracer's shading a frame: the `pt.shade` spans'
CUDA-event time less their shadow queries' (`ray.trace`), over the
profiled frames (`portbench/spans.py`)."""

from portbench.spans import reader

META = {"unit": "ms", "better": "lower", "source": "program_span",
        "layer": "path tracer", "moves": "frame_ms"}
read = reader("pt.shade_ms")
