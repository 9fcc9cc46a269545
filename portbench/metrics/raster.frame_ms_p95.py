"""The 95th percentile of the raster frames' frame-to-frame intervals,
between consecutive frames' end events, in the traced run's window after
its profiled frames (the host sets the pace here, so the tail is a
per-layer reading, not an end-to-end one)."""

from portbench.readers import interval_p95 as read  # noqa: F401

META = {"unit": "ms", "better": "lower", "source": "host_clock",
        "layer": "entry", "moves": "raster_frame_ms"}
