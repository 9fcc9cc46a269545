"""The raster frame: the window's time over the frames completed in it
(its own metric: the host sets its pace, and its runs spread several
times wider than the path-traced frame's, which a shared bound would
leave loose)."""

from portbench.readers import ms_per_unit as read  # noqa: F401

META = {"unit": "ms", "better": "lower", "bound": 0.25,
        "source": "host_clock"}
