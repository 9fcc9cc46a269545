"""The path-traced frame: the window's time over the frames completed in
it."""

from portbench.readers import ms_per_unit as read  # noqa: F401

META = {"unit": "ms", "better": "lower", "bound": 0.05,
        "source": "host_clock"}
