"""Device kernels in the profiled path-traced frames (copies and fills
left out) over the frames."""

from portbench.readers import launches as read  # noqa: F401

META = {"unit": "launches/frame", "better": "lower",
        "source": "device_trace", "layer": "dispatch", "moves": "frame_ms"}
