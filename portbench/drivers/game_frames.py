"""Game frames: `entry.flythrough_entry()`'s per-frame `fn` called back to
back, each call one frame of the engine's loop: one 60 Hz physics frame of
the pile, the instances posed into their tree, the sun's cascades and the
raster frame, the camera moving on its orbit, TAA history carried, a new
sub-pixel jitter each frame drawn from the seed.  The pile's bodies are
drawn from the seed too (`pile_seed`).

The checked calls keep what the frame started from (the bodies, the frame
state, the previous camera), its jitter, and what it made (the bodies
after it, the posed triangles, the cascades, the LDR frame); after the
window the plain reference (`reference/game.py`) steps the same bodies one
frame, renders the same frame from the same inputs and traces again a grid
of every cascade's texels.  The calls that time the program's spans pass
`profile_stages` and keep its stage times and counters by name."""

from __future__ import annotations

import random
import time
from collections import defaultdict

from ..inputs import checked_calls

BODY_FIELDS = ("pos", "rot", "vel", "omega", "force", "torque")


def _clones(obj, fields):
    return {k: getattr(obj, k).clone() for k in fields}


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.units_per_call = 1
        self.check_at = set(checked_calls(cell.seed, cell.traffic))
        self.kept = []
        self.spans = defaultdict(list)
        self.marks = []

    def setup(self):
        import torch

        from d3d12renderer_tpu_torch import entry as port

        self.marks.append(("port import", time.perf_counter()))
        cell, cfg = self.cell, self.cell.config
        out = port.flythrough_entry(
            device=cell.device, width=cfg["width"], height=cfg["height"],
            frames=0, settle_frames=cfg["physics"]["settle_frames"],
            seed=cell.seed,
            shadow_resolution=cfg["raster"]["cascade_resolution"],
            orbit_frames=cfg["camera"]["orbit_frames"], pile_seed=cell.seed,
            half_res_effects=cfg["raster"]["half_res_effects"])
        self.fn, self.game = out["fn"], out["start"]
        self.marks.append(("entry", time.perf_counter()))
        self.jitters = torch.Generator(device=cell.device).manual_seed(
            cell.seed ^ 0x2545F491)
        for _ in range(cell.traffic["warmup_calls"]):
            self._frame()
        self.marks.append(("warm-up", time.perf_counter()))

    def _frame(self, profile_stages=False):
        import torch

        jitter = torch.rand(2, generator=self.jitters, device=self.cell.device)
        ldr, self.game, aux = self.fn(self.game, jitter=jitter,
                                      profile_stages=profile_stages)
        if profile_stages:
            for name, value in {**aux["stage_ms"], **aux["counts"]}.items():
                self.spans[name].append(value)
        return jitter, ldr, aux

    def call(self, i: int, mode: str = "window"):
        from ..reference.game import TRIANGLE_FIELDS, camera_fields
        from ..reference.raster import FRAME_STATE_FIELDS, SHADOW_FIELDS

        stages = mode == "spans"
        if i not in self.check_at:
            self._frame(stages)
            return
        start = self.game
        bodies = _clones(start.bodies, BODY_FIELDS)
        state = _clones(start.frame_state, FRAME_STATE_FIELDS)
        jitter, ldr, aux = self._frame(stages)
        camera = camera_fields(self.game.prev_camera)
        self.kept.append({
            "call": i, "bodies": bodies, "state": state, "jitter": jitter,
            "camera": camera,
            "prev_camera": (camera if start.prev_camera is None
                            else camera_fields(start.prev_camera)),
            "after": _clones(self.game.bodies, BODY_FIELDS),
            "triangles": _clones(aux["bvh"], TRIANGLE_FIELDS),
            "shadow_maps": _clones(aux["shadow_maps"], SHADOW_FIELDS),
            "ldr": ldr.clone()})

    def free(self):
        self.fn = self.game = None

    def _texels(self, depth, device):
        """(cascade, row, column) of the checked texels: each cascade cut
        into a `texel_grid`^2 grid, one texel drawn from the seed in each
        grid cell."""
        import torch

        c, r, _ = depth.shape
        g = min(self.cell.traffic["texel_grid"], r)
        rng = random.Random(self.cell.seed ^ 0x7E1)
        edges = [k * r // g for k in range(g + 1)]
        picks = [(k, rng.randrange(edges[y], edges[y + 1]),
                  rng.randrange(edges[x], edges[x + 1]))
                 for k in range(c) for y in range(g) for x in range(g)]
        t = torch.tensor(picks, device=device)
        return t[:, 0], t[:, 1], t[:, 2]

    def _inputs(self, kept):
        from ..reference.game import FrameInputs

        return FrameInputs(triangles=kept["triangles"], state=kept["state"],
                           shadow_maps=kept["shadow_maps"],
                           camera=kept["camera"],
                           prev_camera=kept["prev_camera"],
                           jitter=kept["jitter"])

    def check(self, run):
        from ..reference import game, raster

        cfg, dev = self.cell.config, self.cell.device
        arch = game.pile_archetype(cfg, self.cell.seed, dev)
        worst = {"pose_gap": 0.0, "vel_gap": 0.0, "pixels_off": 0.0,
                 "mean_gap": 0.0, "shadow_texels_off": 0.0}
        rows = []
        for kept in self.kept:
            ref_bodies, contacts = game.physics_frame(arch, kept["bodies"],
                                                      cfg)
            rows.append(game.contact_rows(contacts))
            gaps = game.body_gaps(kept["after"], ref_bodies)
            scene = game.PosedScene(cfg, kept["triangles"])
            ref = game.frame(scene, cfg, self._inputs(kept))
            gaps.update(raster.gaps(kept["ldr"], ref))
            maps = kept["shadow_maps"]
            texels = self._texels(maps["depth"], dev)
            gaps["shadow_texels_off"] = raster.texels_off(
                maps["depth"][texels],
                raster.texel_depths(scene, maps, texels), texels[0])
            for k, v in gaps.items():
                worst[k] = max(worst[k], v)
        if rows:
            run.counts["reference_contact_rows"] = sum(rows) / len(rows)
        return worst, len(self.kept)

    def control(self, run, dtype):
        """The control's gaps: the reference in `dtype` in the program's
        place (the physics from the body state rounded to `dtype`, the
        frame and the texels computed in it), against the float32
        reference, on the same frames."""
        from ..reference import game, raster

        cfg, dev = self.cell.config, self.cell.device
        arch = game.pile_archetype(cfg, self.cell.seed, dev)
        worst = {"pose_gap": 0.0, "vel_gap": 0.0, "pixels_off": 0.0,
                 "mean_gap": 0.0, "shadow_texels_off": 0.0}
        for kept in self.kept:
            ref_bodies, _ = game.physics_frame(arch, kept["bodies"], cfg)
            low_bodies, _ = game.physics_frame(
                arch, game.lowered_bodies(kept["bodies"], dtype), cfg)
            gaps = game.body_gaps({k: getattr(low_bodies, k)
                                   for k in BODY_FIELDS}, ref_bodies)
            scene = game.PosedScene(cfg, kept["triangles"])
            low = game.PosedScene(cfg, kept["triangles"]).lowered(dtype)
            ref = game.frame(scene, cfg, self._inputs(kept))
            lo = game.frame(low, cfg, self._inputs(kept), dtype)
            gaps.update(raster.gaps(lo, ref))
            maps = kept["shadow_maps"]
            texels = self._texels(maps["depth"], dev)
            gaps["shadow_texels_off"] = raster.texels_off(
                raster.texel_depths(low, maps, texels, dtype),
                raster.texel_depths(scene, maps, texels), texels[0])
            for k, v in gaps.items():
                worst[k] = max(worst[k], v)
        return worst
