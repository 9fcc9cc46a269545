"""The host's time to dispatch one call of the env (policy forward and env
step), no synchronisation: the mean over the window's unprofiled calls."""

META = {"unit": "ms", "better": "lower", "source": "host_clock",
        "layer": "entry", "moves": "env_steps_per_s"}


def read(run):
    xs = run.enqueue_ms
    return sum(xs) / len(xs) if xs else None
