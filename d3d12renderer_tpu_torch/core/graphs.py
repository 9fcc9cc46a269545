"""CUDA graphs of the port's fixed-shape steps, and the hand-written
kernels' launches counted through their replays.

A step that launches thousands of small kernels (a physics frame of the
flythrough's pile, its tree, cascades and raster frame) costs the host
more than the card; captured once into a `torch.cuda.CUDAGraph`, every
later call is one replay.  The kernel wrappers count their launches in
Python (`<wrapper>.launches`), which a replay never reaches, so
`LaunchTally` takes the counts a capture made (and gives them back: a
capture runs nothing) and adds them again at every replay.

`Graphed(fn)` captures a function of tensors: its arguments and results are
tensors, dataclasses, tuples, lists and dicts of them, and other values
(numbers, settings) that are part of the capture's key.  The first call of
a key runs eagerly (it fills the callee's caches and builds its kernels),
the second captures and replays, later ones replay: each copies the
arguments into the graph's own inputs and returns copies of its outputs.
CPU tensors always run eagerly.  The callee must not read the card on the
host or copy host data to it, which a capture refuses; where a capture
fails, that key runs eagerly from then on and `failed` says why.
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

import torch

from . import profiling


def launch_wrappers() -> Dict[str, Callable]:
    """Every kernel wrapper that counts its launches (`.launches`), by
    kernel: #1 colored solve, #2 fused substep, #3 BVH walk, #4 brute
    force, #5 raster (pair and group modes), #6 tonemap, #7 blur, #8 the
    path tracer's two shading kernels, #9 the SSR march."""
    from ..ops import image, pt_shade, raster, ray_trace, ssr
    from ..physics import solver_cuda, substep_cuda

    return {"colored": solver_cuda.colored_solve_cuda,
            "fused": substep_cuda.fused_substep_cuda,
            "bvh": ray_trace.ray_closest_hit_bvh,
            "brute": ray_trace.ray_closest_hit_brute,
            "raster": raster.rasterize_tiles,
            "groups": raster.rasterize_groups,
            "tonemap": image.tonemap, "blur": image.gaussian_blur,
            "shade_hit": pt_shade.shade_hit,
            "shade_next": pt_shade.shade_next, "ssr": ssr.ssr_march}


class LaunchTally:
    """The launches one capture recorded, by wrapper, added back per
    replay.  `wrappers`: name -> object with a `launches` count
    (`launch_wrappers()` by default)."""

    def __init__(self, wrappers: Optional[Dict[str, object]] = None):
        self.wrappers = launch_wrappers() if wrappers is None else wrappers
        self.per_replay: Dict[str, int] = {}

    @contextmanager
    def capturing(self):
        """Around a capture: what the wrappers counted inside is kept as
        one replay's launches and taken off their counts again."""
        before = {k: w.launches for k, w in self.wrappers.items()}
        try:
            yield self
        finally:
            self.per_replay = {k: w.launches - before[k]
                               for k, w in self.wrappers.items()
                               if w.launches != before[k]}
            for k, w in self.wrappers.items():
                w.launches = before[k]

    def replayed(self, times: int = 1):
        """Count `times` replays' launches."""
        for k, n in self.per_replay.items():
            self.wrappers[k].launches += n * times


# --------------------------------------------------------------------------
# Trees of tensors
# --------------------------------------------------------------------------

def flatten(obj, leaves: List[torch.Tensor]):
    """(structure, with every tensor replaced by its index in `leaves`,
    which it is appended to)."""
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return ("T", len(leaves) - 1)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        fields = tuple((f.name, flatten(getattr(obj, f.name), leaves))
                       for f in dataclasses.fields(obj) if f.init)
        return ("D", type(obj), fields)
    if isinstance(obj, (tuple, list)):
        return ("S", type(obj), tuple(flatten(x, leaves) for x in obj))
    if isinstance(obj, dict):
        return ("M", tuple((k, flatten(v, leaves)) for k, v in obj.items()))
    return ("V", obj)


def unflatten(spec, leaves):
    kind = spec[0]
    if kind == "T":
        return leaves[spec[1]]
    if kind == "D":
        return spec[1](**{k: unflatten(s, leaves) for k, s in spec[2]})
    if kind == "S":
        return spec[1](unflatten(s, leaves) for s in spec[2])
    if kind == "M":
        return {k: unflatten(s, leaves) for k, s in spec[1]}
    return spec[1]


def _key(spec, leaves):
    def static(s):
        kind = s[0]
        if kind == "T":
            return s
        if kind == "D":
            return ("D", s[1], tuple((k, static(v)) for k, v in s[2]))
        if kind == "S":
            return ("S", s[1], tuple(static(v) for v in s[2]))
        if kind == "M":
            return ("M", tuple((k, static(v)) for k, v in s[1]))
        try:
            hash(s[1])
            return s
        except TypeError:
            return ("V", id(s[1]))
    return (static(spec), tuple((tuple(t.shape), t.dtype, t.device,
                                 t.stride()) for t in leaves))


class _Capture:
    """One captured call: the graph, its input and output buffers."""

    def __init__(self, fn, spec, leaves):
        self.inputs = [t.clone() for t in leaves]
        self.graph = torch.cuda.CUDAGraph()
        self.tally = LaunchTally()
        args, kwargs = unflatten(spec, self.inputs)
        recording = profiling._enabled
        profiling.set_enabled(False)
        try:
            with self.tally.capturing(), torch.cuda.device(leaves[0].device):
                with torch.cuda.graph(self.graph):
                    out = fn(*args, **kwargs)
        finally:
            profiling.set_enabled(recording)
        self.out_leaves: List[torch.Tensor] = []
        self.out_spec = flatten(out, self.out_leaves)

    def __call__(self, leaves):
        for dst, src in zip(self.inputs, leaves):
            dst.copy_(src)
        self.graph.replay()
        self.tally.replayed()
        return unflatten(self.out_spec, [t.clone() for t in self.out_leaves])


class Graphed:
    """`fn` captured per key (the module's docstring).  `captures` counts
    the captures made, `replays` the replays; `failed` maps a key to the
    error its capture raised."""

    def __init__(self, fn):
        self.fn = fn
        self.seen = set()
        self.graphs: Dict[tuple, _Capture] = {}
        self.failed: Dict[tuple, str] = {}
        self.captures = self.replays = 0

    def __call__(self, *args, **kwargs):
        leaves: List[torch.Tensor] = []
        spec = flatten((args, kwargs), leaves)
        if not leaves or not leaves[0].is_cuda:
            return self.fn(*args, **kwargs)
        key = _key(spec, leaves)
        graph = self.graphs.get(key)
        if graph is None:
            if key not in self.seen or key in self.failed:
                self.seen.add(key)
                return self.fn(*args, **kwargs)
            try:
                graph = self.graphs[key] = _Capture(self.fn, spec, leaves)
                self.captures += 1
            except RuntimeError as e:
                self.failed[key] = str(e)
                torch.cuda.synchronize()
                return self.fn(*args, **kwargs)
        self.replays += 1
        return graph(leaves)
