"""The sun's 3 cascades of a game frame (fit, ray set-up, kernel #3's walk
of the posed instances' tree): the `shadow.cascades` span's CUDA-event
time, the mean over the traced run's frames that time their spans."""

from portbench.readers import span_mean

META = {"unit": "ms", "better": "lower", "source": "program_span",
        "layer": "render", "moves": "frame_ms"}
read = span_mean("shadow.cascades")
