"""Device kernels in the profiled calls (copies and fills left out) over
the control steps they ran: one step of every env per rollout call, the
rollout's steps per PPO iteration (`steps_per_call` of the traffic)."""

from portbench.readers import launches as read  # noqa: F401

META = {"unit": "launches/step", "better": "lower", "source": "device_trace",
        "layer": "dispatch", "moves": "env_steps_per_s"}
