"""Process start to the window's start: imports, the kernel library's
build or load, the scene, weights and warm-up."""

META = {"unit": "s", "better": "lower", "bound": 0.25,
        "source": "host_clock"}


def read(run):
    return run.setup_s
