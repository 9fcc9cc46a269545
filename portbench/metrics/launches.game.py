"""Device kernels in the profiled game frames (copies and fills left out)
over the frames, those replayed from the physics and raster graphs
included."""

from portbench.readers import launches as read  # noqa: F401

META = {"unit": "launches/frame", "better": "lower",
        "source": "device_trace", "layer": "dispatch", "moves": "frame_ms"}
