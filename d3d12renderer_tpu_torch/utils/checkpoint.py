"""Checkpoints and the NaN guard (counterpart of
``d3d12renderer_tpu/utils/checkpoint.py``).

A tree here is nested dicts, lists, tuples, NamedTuples and dataclasses
whose leaves are tensors, `torch.Generator`s, numpy arrays, numbers,
strings or None: a `TrainState` whole.  `save_pytree` writes it in the
port's own format: the tree pickled with every tensor as a numpy array (its
device noted) and every generator as its state, so that `load_pytree` gives
back the same bits on the device asked for.  Reading a checkpoint that the
JAX package wrote would need JAX's treedef, and so JAX: out of scope.
Unpickle only files that this module wrote.

`save_pytree_sharded` / `load_pytree_sharded` do the same for a state
spread over the ranks of a `torch.distributed` group: a spec tree
(`parallel.data_parallel.train_state_spec`) marks each part REPLICATED
(the same on every rank) or SHARDED (each rank's slice along the first
axis, and each rank's own generators).  The file holds the global state:
sharded tensors gathered in rank order, every rank's generator state.

`nan_guard` wraps a step so that a result with a non-finite float rolls
back to the step's input, decided on the device.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

FORMAT = "d3d12renderer_tpu_torch-pytree-1"
# A spec tree's leaves: a part that every rank holds whole, or that each
# rank holds a slice of (tensors, along their first axis) or its own copy
# of (generators).
REPLICATED = "replicated"
SHARDED = "sharded"


class _Tensor:
    """A saved tensor (a leaf: not a container that `tree_map` enters)."""

    def __init__(self, array: np.ndarray, device: str):
        self.array, self.device = array, device


class _Generator:
    """A saved generator: its `get_state()` bytes."""

    def __init__(self, state: np.ndarray, device: str):
        self.state, self.device = state, device


def tree_map(fn: Callable, tree, *rest):
    """`fn` over the leaves of `tree` (and the same leaves of `rest`),
    keeping every container's type."""
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, v, *(r[k] for r in rest)))
                          for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree) if f.init})
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


class _PerRank:
    """A sharded generator in a file: every rank's saved state, in rank
    order (a leaf: not a container that `tree_map` enters)."""

    def __init__(self, states):
        self.states = states


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return _Tensor(x.detach().cpu().numpy(), str(x.device))
    if isinstance(x, torch.Generator):
        return _Generator(x.get_state().numpy(), str(x.device))
    return x


def save_pytree(path: str, tree: Any):
    """Write `tree` to `path` (its directory made if needed)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"format": FORMAT, "tree": tree_map(_to_host, tree)}, f)


def load_pytree(path: str, device=None) -> Any:
    """The tree that `save_pytree` wrote, its tensors and generators on
    `device` (None: where each was saved from)."""
    return tree_map(lambda x: _restore(x, device), _read(path))


def _read(path: str):
    with open(path, "rb") as f:
        doc = pickle.load(f)
    if not isinstance(doc, dict) or doc.get("format") != FORMAT:
        raise ValueError(f"{path} is not a checkpoint of this package "
                         f"(format {FORMAT})")
    return doc["tree"]


def _restore(x, device):
    if isinstance(x, _Tensor):
        return torch.as_tensor(x.array, device=device or x.device)
    if isinstance(x, _Generator):
        g = torch.Generator(device=device or x.device)
        g.set_state(torch.as_tensor(x.state))
        return g
    return x


def map_spec(fn: Callable, spec, tree):
    """`fn(kind, subtree)` over the parts of `tree` that `spec`, a prefix
    of it with REPLICATED / SHARDED leaves, marks."""
    if isinstance(spec, str):
        return fn(spec, tree)
    if isinstance(spec, tuple) and hasattr(spec, "_fields"):
        return type(tree)(*(map_spec(fn, s, t) for s, t in zip(spec, tree)))
    if dataclasses.is_dataclass(spec):
        return dataclasses.replace(tree, **{
            f.name: map_spec(fn, getattr(spec, f.name), getattr(tree, f.name))
            for f in dataclasses.fields(spec) if f.init})
    if isinstance(spec, dict):
        return type(tree)((k, map_spec(fn, spec[k], tree[k])) for k in tree)
    raise TypeError(f"not a spec: {spec!r}")


def save_pytree_sharded(path: str, tree: Any, spec, group=None):
    """Write the global state of a tree spread over `group`'s ranks (the
    default group when None).  Every rank calls it; rank 0 writes.  Sharded
    tensors are gathered along their first axis in rank order, sharded
    generators keep every rank's state; replicated parts are rank 0's."""
    world = dist.get_world_size(group)

    def gather(x):
        if not isinstance(x, (torch.Tensor, torch.Generator)):
            return x
        parts = [None] * world
        dist.all_gather_object(parts, _to_host(x), group=group)
        if isinstance(x, torch.Generator):
            return _PerRank(parts)
        return _Tensor(np.concatenate([p.array for p in parts]), str(x.device))

    def global_part(kind, sub):
        return tree_map(gather, sub) if kind == SHARDED else sub

    whole = map_spec(global_part, spec, tree)
    if dist.get_rank(group) == 0:
        save_pytree(path, whole)
    dist.barrier(group=group)


def load_pytree_sharded(path: str, spec, group=None, device=None) -> Any:
    """This rank's part of the state that `save_pytree_sharded` wrote: its
    slice of every sharded tensor (the first axis split evenly over the
    ranks) and its own generators, the replicated parts whole; on
    `device` (None: this rank's own device of the kind each was saved
    from, `rank_device`)."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)

    def restore(x):
        if isinstance(x, (_Tensor, _Generator)):
            return _restore(x, device if device is not None
                            else rank_device(x.device))
        return x

    def local(x):
        if isinstance(x, _PerRank):
            if len(x.states) != world:
                raise ValueError(f"{path} holds {len(x.states)} ranks' "
                                 f"generators, the group has {world}")
            return restore(x.states[rank])
        if isinstance(x, _Tensor):
            rows = x.array.shape[0] // world
            return restore(_Tensor(x.array[rank * rows:(rank + 1) * rows],
                                   x.device))
        return restore(x)

    def part(kind, sub):
        return tree_map(local if kind == SHARDED else restore, sub)

    return map_spec(part, spec, _read(path))


def rank_device(saved: str) -> str:
    """Where a rank puts a part saved from device `saved`: on its current
    card (`torch.cuda.current_device()`, which `join_process_group` sets)
    for a CUDA device, whichever card rank 0 saved from; else `saved`."""
    if torch.device(saved).type == "cuda":
        return f"cuda:{torch.cuda.current_device()}"
    return saved


class CheckpointManager:
    """The `keep` most recent checkpoints (`ckpt_<step>.bin`) and the best
    by a metric (`best.bin`) in `directory`."""

    def __init__(self, directory: str, keep: int = 3, device=None):
        self.directory = directory
        self.keep = keep
        self.device = device
        self.best_metric = -float("inf")
        os.makedirs(directory, exist_ok=True)

    def _ckpts(self):
        return sorted(f for f in os.listdir(self.directory)
                      if f.startswith("ckpt_"))

    def save(self, step: int, tree: Any, metric: Optional[float] = None):
        path = os.path.join(self.directory, f"ckpt_{step:09d}.bin")
        save_pytree(path, tree)
        if metric is not None and metric > self.best_metric:
            self.best_metric = metric
            save_pytree(os.path.join(self.directory, "best.bin"), tree)
        for old in self._ckpts()[:-self.keep]:
            os.remove(os.path.join(self.directory, old))
        return path

    def latest(self) -> Optional[Any]:
        ckpts = self._ckpts()
        return (load_pytree(os.path.join(self.directory, ckpts[-1]),
                            self.device) if ckpts else None)

    def latest_step(self) -> Optional[int]:
        ckpts = self._ckpts()
        return int(ckpts[-1][5:14]) if ckpts else None

    def best(self) -> Optional[Any]:
        p = os.path.join(self.directory, "best.bin")
        return load_pytree(p, self.device) if os.path.exists(p) else None


def tree_all_finite(tree) -> torch.Tensor:
    """A 0-d bool tensor: every float tensor leaf is finite (no host
    read)."""
    checks = [torch.isfinite(x).all() for x in tree_leaves(tree)
              if isinstance(x, torch.Tensor) and x.is_floating_point()]
    if not checks:
        return torch.ones((), dtype=torch.bool)
    return torch.stack([c.to(checks[0].device) for c in checks]).all()


def nan_guard(step_fn: Callable):
    """Wrap `state' = step_fn(state, *a)` so that a result with a non-finite
    float leaf rolls back to the input state.  Returns wrapped(state, *args)
    -> (state', rolled_back), `rolled_back` a 0-d bool tensor.  Tensor
    leaves are chosen on the device; other leaves (generators) come from
    the new state."""

    def wrapped(state, *args, **kw):
        new_state = step_fn(state, *args, **kw)
        ok = tree_all_finite(new_state)

        def pick(new, old):
            if isinstance(new, torch.Tensor):
                return torch.where(ok.to(new.device), new, old)
            return new

        return tree_map(pick, new_state, state), ~ok

    return wrapped
