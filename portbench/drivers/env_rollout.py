"""Closed-loop rollout: `entry.entry(batch=envs)`'s `fn` called back to
back, each call the policy's mean action and one env step of every env
(pokes and auto-reset included).  The checked calls keep the program's
state before the step and its answer; after the window the plain
reference recomputes each of those steps."""

from __future__ import annotations

from ..inputs import checked_calls, policy_weights

BODY_FIELDS = ("pos", "rot", "vel", "omega", "force", "torque")


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.units_per_call = cell.config["envs"]
        self.check_at = set(checked_calls(cell.seed, cell.traffic))
        self.kept = []

    def setup(self):
        import torch

        from d3d12renderer_tpu_torch import entry as port

        cell = self.cell
        self.fn, (model, state, obs) = port.entry(
            device=cell.device, batch=cell.config["envs"], seed=cell.seed)
        self.weights = policy_weights(cell.config, cell.seed, cell.device)
        with torch.no_grad():
            for name, p in model.state_dict().items():
                p.copy_(self.weights[name])
        self.model, self.state, self.obs = model, state, obs
        self.start = {f: getattr(state.bodies, f).clone()
                      for f in ("pos", "rot", "vel", "omega")}
        self.start["obs"] = obs.clone()
        for _ in range(cell.traffic["warmup_calls"]):
            self._step()

    def _step(self):
        self.obs, self.state, self.reward, self.done = self.fn(
            self.model, self.state, self.obs)

    def call(self, i: int, mode: str = "window"):
        if i not in self.check_at:
            self._step()
            return
        s = self.state
        before = {f: getattr(s.bodies, f).clone() for f in BODY_FIELDS}
        before.update(last_action=s.last_action.clone(),
                      obs=self.obs.clone())
        gen_state = s.generator.get_state()
        self._step()
        b = self.state.bodies
        answer = {f: getattr(b, f).clone() for f in ("pos", "rot", "vel",
                                                     "omega")}
        answer.update(obs=self.obs.clone(), reward=self.reward.clone(),
                      done=self.done.clone())
        self.kept.append((i, before, gen_state, answer))

    def free(self):
        """Drop the program's state once the window is read."""
        self.fn = self.model = self.state = self.obs = None
        self.reward = self.done = None

    def check(self, run):
        """The reference's gaps, widest over the checked calls."""
        from ..reference import loco

        ref = loco.Reference(self.cell.device)
        worst = {k: 0.0 for k in loco.GAPS}
        points = []
        for _, before, gen_state, answer in self.kept:
            r = ref.step(self.weights, before, gen_state)
            points.append(r["points"])
            for k, v in loco.gaps(answer, r).items():
                worst[k] = max(worst[k], v)
        run.counts["contact_points"] = (sum(points) / len(points)
                                        if points else None)
        # The start the checked steps follow from: every env in the
        # reference's standing pose.
        start = loco.start_gaps(ref.env, self.start)
        worst["pose_gap"] = max(worst["pose_gap"], start["pose_gap"])
        worst["obs_gap"] = max(worst["obs_gap"], start["obs_gap"])
        return worst, len(self.kept)

    def control(self, run, dtype):
        """The control's gaps: the reference in `dtype` in the program's
        place, against the float32 reference, on the same checked calls."""
        from ..reference import loco

        ref = loco.Reference(self.cell.device)
        low = loco.Reference(self.cell.device, dtype)
        worst = {k: 0.0 for k in loco.GAPS}
        for _, before, gen_state, _ in self.kept:
            r = ref.step(self.weights, before, gen_state)
            lo = low.step(self.weights, before, gen_state)
            for k, v in loco.gaps(lo, r).items():
                worst[k] = max(worst[k], v)
        return worst
