"""Undo stack: byte-blob toggle entries over a ring buffer (counterpart of
``d3d12renderer_tpu/utils/undo.py``; host-only).

Reference: src/editor/undo_stack.h:6-40 — entries store an opaque byte blob
plus a toggle callback; undo/redo re-applies the blob and swaps it with the
current state; `verify()` walks the ring for consistency.  Here entries are
picklable snapshots (scene descriptions, components) with the same
toggle-on-undo/redo semantics.
"""

from __future__ import annotations

import pickle
from typing import Any, Callable, List, Optional, Tuple

DEFAULT_CAPACITY = 128


class UndoStack:
    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = capacity
        self._entries: List[Tuple[str, bytes, Callable]] = []
        self._cursor = 0  # entries[:cursor] are applied

    def push(self, name: str, state: Any, toggle: Callable[[Any], Any]):
        """Record an undo point.  `toggle(old_state) -> current_state` applies
        the stored state and returns the replaced one (the reference's toggle
        pattern: one callback serves both undo and redo)."""
        del self._entries[self._cursor:]
        self._entries.append((name, pickle.dumps(state), toggle))
        if len(self._entries) > self.capacity:
            self._entries.pop(0)
        self._cursor = len(self._entries)

    def undo(self) -> Optional[str]:
        if self._cursor == 0:
            return None
        self._cursor -= 1
        name, blob, toggle = self._entries[self._cursor]
        replaced = toggle(pickle.loads(blob))
        self._entries[self._cursor] = (name, pickle.dumps(replaced), toggle)
        return name

    def redo(self) -> Optional[str]:
        if self._cursor >= len(self._entries):
            return None
        name, blob, toggle = self._entries[self._cursor]
        replaced = toggle(pickle.loads(blob))
        self._entries[self._cursor] = (name, pickle.dumps(replaced), toggle)
        self._cursor += 1
        return name

    @property
    def undo_name(self) -> Optional[str]:
        return self._entries[self._cursor - 1][0] if self._cursor else None

    @property
    def redo_name(self) -> Optional[str]:
        return (self._entries[self._cursor][0]
                if self._cursor < len(self._entries) else None)

    def verify(self) -> bool:
        """Consistency walk (reference: undo_stack.h:22 verify)."""
        return 0 <= self._cursor <= len(self._entries) <= self.capacity
