"""The rollout phase of a PPO iteration: `train_iteration(profile_phases=True)`'s
CUDA events around it, the mean over the traced run's iterations that time it
(after the window, before the profiled ones)."""

from portbench.readers import span_mean

META = {"unit": "ms", "better": "lower", "source": "program_span",
        "layer": "learning", "moves": "env_steps_per_s"}
read = span_mean('rollout')
