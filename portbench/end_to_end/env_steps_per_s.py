"""Every env step completed in the window over the window's time."""

META = {"unit": "env-steps/s", "better": "higher", "bound": 0.25,
        "source": "host_clock"}


def read(run):
    return run.units / run.window_s if run.window_s > 0 else None
