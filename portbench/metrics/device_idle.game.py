"""The share of the profiled game frames' host window in which no
operation ran on the device (`readers.device_idle`)."""

from portbench.readers import device_idle as read  # noqa: F401

META = {"unit": "%", "better": "lower", "source": "device_trace",
        "layer": "device", "moves": "frame_ms"}
