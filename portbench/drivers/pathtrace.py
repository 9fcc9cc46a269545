"""Progressive path tracing: `entry.pathtrace_entry()`'s `fn` called back to
back, each call one frame at one sample per pixel, accumulated into a
running mean as a progressive render does.  The checked calls keep the
frame's generator state and the program's frame; after the window the plain
reference traces a sample of their pixels again, counting the rays their
paths need."""

from __future__ import annotations

import random
import sys
import time

from ..inputs import checked_calls


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.units_per_call = 1
        self.check_at = set(checked_calls(cell.seed, cell.traffic))
        self.kept = []
        self.rays_profiled = None
        self.marks = []

    def setup(self):
        import torch

        from d3d12renderer_tpu_torch import entry as port

        self.marks.append(("port import", time.perf_counter()))
        cell = self.cell
        cfg = cell.config
        self.fn, (self.scene, self.camera, self.sampler) = port.pathtrace_entry(
            device=cell.device, width=cfg["width"], height=cfg["height"],
            recursion_depth=cfg["path_tracer"]["depth"], seed=cell.seed)
        self.marks.append(("entry", time.perf_counter()))
        self.accum = torch.zeros((cfg["height"], cfg["width"], 3),
                                 device=cell.device)
        self.frames = 0
        for _ in range(cell.traffic["warmup_calls"]):
            self._frame()
        self.accum.zero_()
        self.frames = 0
        self.marks.append(("warm-up", time.perf_counter()))

    def _frame(self):
        image, rays = self.fn(self.scene, self.camera, self.sampler)
        self.frames += 1
        self.accum += (image - self.accum) / self.frames
        return image, rays

    def call(self, i: int, mode: str = "window"):
        if i not in self.check_at:
            _, rays = self._frame()
        else:
            state = self.sampler.generator.get_state()
            image, rays = self._frame()
            self.kept.append((i, state, image.clone()))
        if mode == "profiled":
            self.rays_profiled = (rays if self.rays_profiled is None
                                  else self.rays_profiled + rays)

    def free(self):
        if self.rays_profiled is not None:
            self.rays_profiled = int(self.rays_profiled)
        self.fn = self.scene = self.camera = self.sampler = None
        self.accum = None

    def _pixels(self, device):
        import torch

        cfg = self.cell.config
        rng = random.Random(self.cell.seed ^ 0x5EED)
        n = min(self.cell.traffic["checked_pixels"],
                cfg["width"] * cfg["height"])
        return torch.tensor(sorted(rng.sample(range(cfg["width"]
                                                    * cfg["height"]), n)),
                            device=device)

    def check(self, run):
        """The sampled pixels' gaps; the reference's rays a pixel over
        them go to `run.counts` for the BVH walk's roofline."""
        from ..reference import pathtrace

        scene = pathtrace.Atrium(self.cell.config, self.cell.device)
        pixels = self._pixels(self.cell.device)
        worst = {"pixels_off": 0.0, "mean_gap": 0.0}
        counts = {}
        for _, state, image in self.kept:
            ref = pathtrace.radiance(scene, state, pixels, counts=counts)
            answer = image.reshape(-1, 3)[pixels]
            for k, v in pathtrace.gaps(answer, ref).items():
                worst[k] = max(worst[k], v)
        if self.kept:
            per_pixel = counts["rays"] / (len(pixels) * len(self.kept))
            run.counts["rays_per_pixel"] = per_pixel
            if self.rays_profiled is not None and run.trace is not None:
                cfg = self.cell.config
                own = self.rays_profiled / (cfg["width"] * cfg["height"]
                                            * run.trace.calls)
                print(f"rays a pixel: the reference {per_pixel!r} on its "
                      f"{len(pixels)} pixels of {len(self.kept)} frames, the "
                      f"program's own count {own!r} on the profiled frames",
                      file=sys.stderr)
        return worst, len(self.kept)

    def control(self, run, dtype):
        """The control's gaps: the reference in `dtype` in the program's
        place, against the float32 reference, on the same frames."""
        import torch

        from ..reference import pathtrace

        ref_scene = pathtrace.Atrium(self.cell.config, self.cell.device)
        low_scene = pathtrace.Atrium(self.cell.config,
                                     self.cell.device).lowered(dtype)
        pixels = self._pixels(self.cell.device)
        worst = {"pixels_off": 0.0, "mean_gap": 0.0}
        for _, state, _ in self.kept:
            ref = pathtrace.radiance(ref_scene, state, pixels, torch.float32)
            low = pathtrace.radiance(low_scene, state, pixels, dtype)
            for k, v in pathtrace.gaps(low, ref).items():
                worst[k] = max(worst[k], v)
        return worst
