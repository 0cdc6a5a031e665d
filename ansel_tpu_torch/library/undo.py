"""Typed undo/redo stack (`ansel_tpu/library/undo.py`, copied).

Reference: `ansel/src/common/undo.c` (:30-120 record list with
type tags, undo/redo traversal, per-type clearing).  Headless scope:
history-edit snapshots per image (the darkroom's dominant undo type),
applied back through the library's history store.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, List, Optional, Tuple

UNDO_HISTORY = "history"
UNDO_RATINGS = "ratings"
UNDO_TAGS = "tags"


class UndoStack:
    """dt_undo_t analog: bounded LIFO of (type, imgid, before, after)."""

    def __init__(self, limit: int = 100):
        self.limit = limit
        self._undo: List[Tuple[str, int, Any, Any]] = []
        self._redo: List[Tuple[str, int, Any, Any]] = []

    def record(self, kind: str, imgid: int, before: Any, after: Any):
        """Push one already-performed change (undo.c dt_undo_record)."""
        self._undo.append((kind, imgid,
                           copy.deepcopy(before), copy.deepcopy(after)))
        del self._undo[: -self.limit]
        self._redo.clear()

    def undo(self, apply: Callable[[str, int, Any], None]) -> bool:
        """Pop + apply the 'before' state; -> False when empty."""
        if not self._undo:
            return False
        item = self._undo.pop()
        self._redo.append(item)
        apply(item[0], item[1], item[2])
        return True

    def redo(self, apply: Callable[[str, int, Any], None]) -> bool:
        if not self._redo:
            return False
        item = self._redo.pop()
        self._undo.append(item)
        apply(item[0], item[1], item[3])
        return True

    def clear(self, kind: Optional[str] = None):
        """Drop all records (or one type — undo.c dt_undo_clear)."""
        if kind is None:
            self._undo.clear()
            self._redo.clear()
        else:
            self._undo = [r for r in self._undo if r[0] != kind]
            self._redo = [r for r in self._redo if r[0] != kind]


def history_editor(lib) -> "HistoryEditor":
    return HistoryEditor(lib)


class HistoryEditor:
    """Library history edits routed through an UndoStack."""

    def __init__(self, lib, limit: int = 100):
        self.lib = lib
        self.stack = UndoStack(limit)

    def write_history(self, imgid: int, history):
        before = self.lib.read_history(imgid)
        self.lib.write_history(imgid, history)
        self.stack.record(UNDO_HISTORY, imgid, before,
                          self.lib.read_history(imgid))

    def set_rating(self, imgid: int, stars: int):
        before = self.lib.rating(imgid)
        self.lib.set_rating(imgid, stars)
        self.stack.record(UNDO_RATINGS, imgid, before, stars)

    def _apply(self, kind: str, imgid: int, state):
        if kind == UNDO_HISTORY:
            self.lib.write_history(imgid, state)
        elif kind == UNDO_RATINGS:
            self.lib.set_rating(imgid, state)

    def undo(self) -> bool:
        return self.stack.undo(self._apply)

    def redo(self) -> bool:
        return self.stack.redo(self._apply)
