"""Real-time raster frames: `entry.raster_entry()`'s `fn` called back to
back, TAA history carried, each frame with a new sub-pixel jitter that the
benchmark draws from the seed.  The checked calls keep the frame state
before the frame, its jitter and the program's LDR frame; after the window
the plain reference renders those frames again from the same state, and
traces again a sample of the set-up's shadow-map texels, spread over every
cascade on a grid.

The entry renders its cascades at `entry.RASTER_SHADOW_RESOLUTION`^2 and
takes no argument for it, so the driver sets that name to the
configuration's `cascade_resolution` before it calls the entry."""

from __future__ import annotations

import random
import time

from ..inputs import checked_calls

STAGES = ("gbuffer", "effects", "opaque", "reflections", "compose", "taa",
          "post")


def _tensors(obj, fields):
    return {k: getattr(obj, k).clone() for k in fields}


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.units_per_call = 1
        self.check_at = set(checked_calls(cell.seed, cell.traffic))
        self.kept = []
        self.spans = {s: [] for s in STAGES}
        self.marks = []

    def setup(self):
        import torch

        from d3d12renderer_tpu_torch import entry as port

        self.marks.append(("port import", time.perf_counter()))
        cell, cfg = self.cell, self.cell.config
        if not hasattr(port, "RASTER_SHADOW_RESOLUTION"):
            raise RuntimeError("entry.RASTER_SHADOW_RESOLUTION is gone: the "
                               "cascades' size cannot be set")
        port.RASTER_SHADOW_RESOLUTION = cfg["raster"]["cascade_resolution"]
        self.fn, self.state = port.raster_entry(
            device=cell.device, width=cfg["width"], height=cfg["height"],
            seed=cell.seed)
        self.marks.append(("entry", time.perf_counter()))
        self.jitters = torch.Generator(device=cell.device).manual_seed(
            cell.seed ^ 0x2545F491)
        # The first frame, from the entry's initial state, is checked
        # against the reference's own initial state.
        self.first = self._frame()
        for _ in range(cell.traffic["warmup_calls"] - 1):
            self._frame()
        self.marks.append(("warm-up", time.perf_counter()))

    def _frame(self, profile_stages=False):
        import torch

        jitter = torch.rand(2, generator=self.jitters, device=self.cell.device)
        ldr, self.state, aux = self.fn(self.state, jitter=jitter,
                                       profile_stages=profile_stages)
        if profile_stages:
            for name, ms in aux["stage_ms"].items():
                self.spans[name].append(ms)
        return jitter, ldr

    def call(self, i: int, mode: str = "window"):
        from ..reference.raster import FRAME_STATE_FIELDS

        stages = mode == "spans"
        if i not in self.check_at:
            self._frame(stages)
            return
        before = _tensors(self.state, FRAME_STATE_FIELDS)
        jitter, ldr = self._frame(stages)
        self.kept.append((i, before, jitter.clone(), ldr.clone()))

    def free(self):
        from ..reference.raster import SHADOW_FIELDS

        self.shadow_maps = _tensors(self.fn.options["shadow_maps"],
                                    SHADOW_FIELDS)
        self.fn = self.state = None

    def _texels(self, device):
        """(cascade, row, column) of the checked texels: each cascade cut
        into a `texel_grid`^2 grid, one texel drawn from the seed in each
        grid cell, so that every region of every cascade is sampled."""
        import torch

        c, r, _ = self.shadow_maps["depth"].shape
        g = min(self.cell.traffic["texel_grid"], r)
        rng = random.Random(self.cell.seed ^ 0x7E1)
        edges = [k * r // g for k in range(g + 1)]
        picks = [(k, rng.randrange(edges[y], edges[y + 1]),
                  rng.randrange(edges[x], edges[x + 1]))
                 for k in range(c) for y in range(g) for x in range(g)]
        t = torch.tensor(picks, device=device)
        return t[:, 0], t[:, 1], t[:, 2]

    def check(self, run):
        from ..reference import pathtrace, raster

        scene = pathtrace.Atrium(self.cell.config, self.cell.device)
        start = raster.initial_state(scene)
        worst = {"pixels_off": 0.0, "mean_gap": 0.0}
        for before, jitter, ldr in ([(start,) + self.first]
                                    + [k[1:] for k in self.kept]):
            ref = raster.frame(scene, self.cell.config, self.shadow_maps,
                               before, jitter)
            for k, v in raster.gaps(ldr, ref).items():
                worst[k] = max(worst[k], v)
        texels = self._texels(self.cell.device)
        worst["shadow_texels_off"] = raster.texels_off(
            self.shadow_maps["depth"][texels],
            raster.texel_depths(scene, self.shadow_maps, texels), texels[0])
        return worst, len(self.kept)

    def control(self, run, dtype):
        """The reference in `dtype` in the program's place, against the
        float32 reference, on the same frames."""
        import torch

        from ..reference import pathtrace, raster

        scene = pathtrace.Atrium(self.cell.config, self.cell.device)
        low = pathtrace.Atrium(self.cell.config,
                               self.cell.device).lowered(dtype)
        worst = {"pixels_off": 0.0, "mean_gap": 0.0}
        for _, before, jitter, _ in self.kept:
            ref = raster.frame(scene, self.cell.config, self.shadow_maps,
                               before, jitter)
            lo = raster.frame(low, self.cell.config, self.shadow_maps, before,
                              jitter, dtype)
            for k, v in raster.gaps(lo, ref).items():
                worst[k] = max(worst[k], v)
        texels = self._texels(self.cell.device)
        worst["shadow_texels_off"] = raster.texels_off(
            raster.texel_depths(low, self.shadow_maps, texels, dtype),
            raster.texel_depths(scene, self.shadow_maps, texels), texels[0])
        return worst
