"""Binary derived-data cache and file registry (counterpart of
``d3d12renderer_tpu/assets/cache.py``; the same cache file names, version
and pickle format, so that either package reads the other's files).

A source loads once through its loader into a `<source>.cache_<sha1>.bin`
blob keyed by the load flags, invalidated when the source's mtime or the
cache version changes.  Images cache in compressed form (`texcompress`).
The file registry maps stable random uint64 handles to paths, persisted to
YAML (PyYAML is imported only by `FileRegistry`) and kept in sync by a
polling watcher thread.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import random
import threading
from typing import Callable, Dict, Optional

import numpy as np

CACHE_VERSION = 2  # v2: compressed texture payloads (BC1/f16 mips)


def _cache_path(source_path: str, flags_key: str) -> str:
    h = hashlib.sha1(flags_key.encode()).hexdigest()[:8]
    return f"{source_path}.cache_{h}.bin"


def load_with_cache(source_path: str, loader: Callable, flags_key: str = "",
                    pack: Optional[Callable] = None,
                    unpack: Optional[Callable] = None):
    """Load `source_path` through `loader`, caching the result next to the
    source; invalidated when the source mtime or cache version changes
    (reference: model_asset.cpp:23-63).

    `pack`/`unpack` transform the payload to/from its on-disk form (e.g.
    BC1/f16 texture compression, reference .cache.dds image.cpp:76-96).
    A cache MISS also returns `unpack(pack(result))` so hits and misses
    return bit-identical data."""
    cpath = _cache_path(source_path, flags_key)
    src_mtime = os.path.getmtime(source_path)
    if os.path.exists(cpath):
        try:
            with open(cpath, "rb") as f:
                header = pickle.load(f)
                if (header.get("version") == CACHE_VERSION
                        and header.get("mtime") == src_mtime):
                    payload = pickle.load(f)
                    return (unpack(payload) if unpack else payload), True
        except Exception:
            pass
    result = loader(source_path)
    payload = pack(result) if pack else result
    with open(cpath, "wb") as f:
        pickle.dump({"version": CACHE_VERSION, "mtime": src_mtime}, f)
        pickle.dump(payload, f)
    if pack:
        result = unpack(payload)
    return result, False


def load_image(path: str, generate_mips: bool = False):
    """Decode an image to float32 linear RGB (reference: asset/image.cpp:76-96
    — WIC/HDR/TGA/DDS decode + mip gen).  Float formats (.hdr RGBE, .exr)
    and 16-bit PNGs decode to linear radiance directly; 8-bit images are
    sRGB-decoded."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".hdr":
        from .image_io import load_hdr
        arr = load_hdr(path)
    elif ext == ".exr":
        from .image_io import load_exr
        arr = load_exr(path)
    else:
        from PIL import Image

        img = Image.open(path)
        raw = np.asarray(img)
        if raw.dtype == np.uint16:          # 16-bit PNG: linear data
            from .image_io import load_png16
            arr = load_png16(path)
        else:
            arr = np.asarray(img.convert("RGB"), np.float32) / 255.0
            arr = np.where(arr <= 0.04045, arr / 12.92,
                           ((arr + 0.055) / 1.055) ** 2.4)
    if not generate_mips:
        return [arr]
    mips = [arr]
    while min(mips[-1].shape[:2]) > 1:
        m = mips[-1]
        h, w = m.shape[0] // 2 * 2, m.shape[1] // 2 * 2
        m = m[:h, :w]
        mips.append(0.25 * (m[0::2, 0::2] + m[1::2, 0::2]
                            + m[0::2, 1::2] + m[1::2, 1::2]))
    return mips


def load_image_cached(path: str, generate_mips: bool = False):
    """Image through the derived cache in COMPRESSED form: LDR RGB mips
    store as BC1 blocks (0.5 B/texel, 24x smaller than raw float32), HDR
    and high-bit-depth mips as float16 (2x), the stand-in for the
    reference's `.cache.dds` BC path (src/asset/image.cpp:76-96).
    Returned mips are float32 linear either way (decode happens at load)."""
    from . import texcompress

    ext = os.path.splitext(path)[1].lower()
    hdr = ext in (".hdr", ".exr")
    return load_with_cache(
        path, lambda p: load_image(p, generate_mips),
        flags_key=f"mips={generate_mips}",
        pack=lambda mips: texcompress.pack_mips(mips, hdr=hdr),
        unpack=texcompress.unpack_mips)


class FileRegistry:
    """Stable asset_handle <-> path map persisted to YAML, kept in sync by a
    polling watcher thread (reference: file_registry.cpp:16-171; inotify-style
    behavior via mtime polling for portability)."""

    def __init__(self, root: str, registry_file: str = "files.yaml",
                 seed: Optional[int] = None):
        self.root = os.path.abspath(root)
        self.registry_path = os.path.join(self.root, registry_file)
        self._rng = random.Random(seed)
        self.handle_to_path: Dict[int, str] = {}
        self.path_to_handle: Dict[str, int] = {}
        self._mtimes: Dict[str, float] = {}
        self._watcher: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._callbacks = []
        self._load()
        self.scan()

    # -- persistence ---------------------------------------------------------

    def _load(self):
        import yaml

        if os.path.exists(self.registry_path):
            with open(self.registry_path) as f:
                doc = yaml.safe_load(f) or {}
            for h, p in (doc.get("files") or {}).items():
                self.handle_to_path[int(h)] = p
                self.path_to_handle[p] = int(h)

    def save(self):
        import yaml

        with open(self.registry_path, "w") as f:
            yaml.safe_dump({"files": {h: p for h, p in
                                      self.handle_to_path.items()}}, f)

    # -- handles --------------------------------------------------------------

    def handle_for(self, path: str) -> int:
        rel = os.path.relpath(os.path.abspath(path), self.root)
        if rel in self.path_to_handle:
            return self.path_to_handle[rel]
        h = self._rng.getrandbits(64)
        while h in self.handle_to_path:
            h = self._rng.getrandbits(64)
        self.handle_to_path[h] = rel
        self.path_to_handle[rel] = h
        return h

    def path_for(self, handle: int) -> Optional[str]:
        rel = self.handle_to_path.get(handle)
        return os.path.join(self.root, rel) if rel else None

    # -- scanning / watching ---------------------------------------------------

    def scan(self):
        """Register all files under root; detect adds/deletes/modifies."""
        seen = {}
        for dirpath, _, files in os.walk(self.root):
            for name in files:
                if name.endswith((".cache.bin", ".yaml")) or "cache_" in name:
                    continue
                p = os.path.join(dirpath, name)
                rel = os.path.relpath(p, self.root)
                seen[rel] = os.path.getmtime(p)
                if rel not in self.path_to_handle:
                    self.handle_for(p)
                    self._emit("added", rel)
                elif rel in self._mtimes and self._mtimes[rel] != seen[rel]:
                    self._emit("modified", rel)
        for rel in list(self._mtimes):
            if rel not in seen and rel in self.path_to_handle:
                self._emit("deleted", rel)
        self._mtimes = seen

    def on_change(self, callback: Callable[[str, str], None]):
        self._callbacks.append(callback)

    def _emit(self, kind: str, rel: str):
        for cb in self._callbacks:
            cb(kind, rel)

    def start_watcher(self, interval: float = 0.5):
        def loop():
            while not self._stop.wait(interval):
                self.scan()

        self._watcher = threading.Thread(target=loop, daemon=True)
        self._watcher.start()

    def stop_watcher(self):
        self._stop.set()
        if self._watcher:
            self._watcher.join(timeout=2)
            self._watcher = None
