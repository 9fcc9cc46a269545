"""The 95th percentile of the window's frame-to-frame intervals, between
consecutive frames' end events (the first from the window's start)."""

from portbench.readers import interval_p95 as read  # noqa: F401

META = {"unit": "ms", "better": "lower", "bound": 0.08,
        "source": "device_trace"}
