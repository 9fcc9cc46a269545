"""The reflections stage of a raster frame: `render_frame(profile_stages=True)`'s
CUDA events around it, the mean over the traced run's frames that time it
(after the window, before the profiled ones)."""

from portbench.readers import span_mean

META = {"unit": "ms", "better": "lower", "source": "program_span",
        "layer": "render", "moves": "raster_frame_ms"}
read = span_mean('reflections')
