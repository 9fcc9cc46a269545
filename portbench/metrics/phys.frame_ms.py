"""The game frame's physics frame (two 120 Hz substeps of the pile, a CUDA
graph's replay after the first): the `phys.frame` span's CUDA-event time
around the replay, the mean over the traced run's frames that time their
spans (after the window, before the profiled ones)."""

from portbench.readers import span_mean

META = {"unit": "ms", "better": "lower", "source": "program_span",
        "layer": "physics", "moves": "frame_ms"}
read = span_mean("phys.frame")
