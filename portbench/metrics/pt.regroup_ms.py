"""Device time of the bounce queries' regroup a frame: the `ray.regroup`
spans' CUDA-event time (the permutation and gathers before a walk, the
scatter back after it), over the profiled frames (`portbench/spans.py`)."""

from portbench.spans import reader

META = {"unit": "ms", "better": "lower", "source": "program_span",
        "layer": "ray queries", "moves": "frame_ms"}
read = reader("pt.regroup_ms")
