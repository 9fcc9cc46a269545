"""Asynchronous asset loading on host threads, with poll-able load-state
handles (counterpart of ``d3d12renderer_tpu/assets/async_loader.py``; the
reference's per-asset atomic load states, src/geometry/mesh.h:22-43).  Only
the host's file IO and parsing need the pool: the card's work is already
asynchronous to the host.  The states are NOT_LOADED / LOADING / LOADED /
FAILED, and completion callbacks chain jobs."""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from enum import Enum
from typing import Any, Callable, Dict, List, Optional


class LoadState(Enum):
    """Mirrors the reference's asset_load_state atomics (mesh.h:22-27)."""

    NOT_LOADED = 0
    LOADING = 1
    LOADED = 2
    FAILED = 3


class AssetHandle:
    """Poll-able result of an async load."""

    def __init__(self, path: str):
        self.path = path
        self._state = LoadState.NOT_LOADED
        self._result: Any = None
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._done = threading.Event()

    @property
    def state(self) -> LoadState:
        return self._state

    @property
    def result(self) -> Any:
        """The loaded asset, or None until LOADED (non-blocking)."""
        return self._result if self._state == LoadState.LOADED else None

    @property
    def error(self) -> Optional[BaseException]:
        return self._error

    def wait(self, timeout: Optional[float] = None) -> Any:
        """Block until loaded; raises on failure."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"asset load timed out: {self.path}")
        if self._state == LoadState.FAILED:
            raise RuntimeError(
                f"asset load failed: {self.path}") from self._error
        return self._result


class AsyncLoader:
    """Thread-pool asset loader with completion chaining.

    `submit(path, loader)` returns an AssetHandle immediately; `on_done`
    callbacks run on the worker thread after the load (the reference's job
    continuation, job_system.h:62-76)."""

    def __init__(self, workers: int = 4):
        self._pool = ThreadPoolExecutor(max_workers=workers,
                                        thread_name_prefix="asset-io")
        self._handles: Dict[str, AssetHandle] = {}
        self._lock = threading.Lock()

    def submit(self, path: str, loader: Callable[[str], Any],
               on_done: Optional[Callable[[AssetHandle], None]] = None,
               ) -> AssetHandle:
        with self._lock:
            cached = self._handles.get(path)
            if cached is not None and cached.state in (LoadState.LOADING,
                                                       LoadState.LOADED):
                return cached
            handle = AssetHandle(path)
            handle._state = LoadState.LOADING
            self._handles[path] = handle

        def run():
            try:
                handle._result = loader(path)
                handle._state = LoadState.LOADED
            except BaseException as e:           # recorded, not raised
                handle._error = e
                handle._state = LoadState.FAILED
            finally:
                handle._done.set()
            if on_done is not None:
                on_done(handle)

        self._pool.submit(run)
        return handle

    def submit_many(self, paths: List[str], loader: Callable[[str], Any],
                    ) -> List[AssetHandle]:
        """The reference's multi-mesh load: all IO in flight concurrently."""
        return [self.submit(p, loader) for p in paths]

    def wait_all(self, handles: List[AssetHandle], timeout=None):
        return [h.wait(timeout) for h in handles]

    def shutdown(self):
        self._pool.shutdown(wait=True)


_default_loader: Optional[AsyncLoader] = None


def default_loader() -> AsyncLoader:
    global _default_loader
    if _default_loader is None:
        _default_loader = AsyncLoader()
    return _default_loader


def load_model_async(path: str) -> AssetHandle:
    """Async ModelAsset load through the binary cache (OBJ/PLY/FBX)."""
    from . import cache as cache_mod
    from .fbx import load_fbx
    from .loaders import load_obj, load_ply

    def load(p: str):
        lower = p.lower()
        if lower.endswith(".obj"):
            return cache_mod.load_with_cache(p, load_obj, "model")[0]
        if lower.endswith(".ply"):
            return cache_mod.load_with_cache(p, load_ply, "model")[0]
        if lower.endswith(".fbx"):
            return cache_mod.load_with_cache(p, load_fbx, "model")[0]
        raise ValueError(f"unknown model format: {p}")

    return default_loader().submit(path, load)
