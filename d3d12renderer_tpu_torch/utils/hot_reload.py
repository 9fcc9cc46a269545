"""Hot-reloadable kernel registry (counterpart of
``d3d12renderer_tpu/utils/hot_reload.py``).

Reference: src/dx/dx_pipeline.h:432-469 — pipelines register by shader
filename; a file watcher recompiles changed shaders and swaps the PSO in
place (dx_pipeline.cpp:412,468).  Here Python entry points register by
source module; when the watcher reports a change, the module reloads and the
cached callable is dropped, so the next call runs the new code.  The CUDA
sources need no such hook: `cuda_build` keys each build by its sources'
hash.
"""

from __future__ import annotations

import importlib
import os
import sys
from typing import Callable, Dict

from ..assets.cache import FileRegistry
from ..core.log import log_info


class KernelRegistry:
    """Named entry points with source-file invalidation."""

    def __init__(self):
        self._entries: Dict[str, dict] = {}

    def register(self, name: str, module_name: str, attr: str):
        """Register `module.attr` as kernel `name` (imported lazily)."""
        self._entries[name] = {"module": module_name, "attr": attr,
                               "loaded": None, "version": 0}

    def get(self, name: str) -> Callable:
        e = self._entries[name]
        if e["loaded"] is None:
            mod = importlib.import_module(e["module"])
            e["loaded"] = getattr(mod, e["attr"])
        return e["loaded"]

    def __call__(self, name: str, *args, **kw):
        return self.get(name)(*args, **kw)

    def invalidate_module(self, module_name: str):
        """Reload the module and drop the cached entries taken from it (the
        PSO-swap equivalent, dx_pipeline.cpp:468)."""
        if module_name in sys.modules:
            importlib.reload(sys.modules[module_name])
        n = 0
        for e in self._entries.values():
            if e["module"] == module_name:
                e["loaded"] = None
                e["version"] += 1
                n += 1
        if n:
            log_info("hot-reloaded %s (%d kernels invalidated)",
                     module_name, n)
        return n

    def version(self, name: str) -> int:
        return self._entries[name]["version"]

    def watch(self, registry: FileRegistry, source_root: str,
              package_prefix: str):
        """Wire a FileRegistry watcher: .py changes under `source_root`
        reload the corresponding module."""

        def on_change(kind: str, rel: str):
            if kind != "modified" or not rel.endswith(".py"):
                return
            mod = package_prefix + "." + rel[:-3].replace(os.sep, ".")
            mod = mod.replace(".__init__", "")
            if mod in sys.modules:
                self.invalidate_module(mod)

        registry.on_change(on_change)


# A process-wide default registry, like the reference's global pipeline list.
kernels = KernelRegistry()
