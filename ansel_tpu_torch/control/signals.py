"""Signal bus: pub/sub for pipeline and library events
(`ansel_tpu/control/signals.py`, copied).

Reference: `ansel/src/control/signal.{c,h}` (GObject pub/sub,
~50 signals in dt_signal_t, signal.h:56-336).  The headless subset keeps
the reference's signal names that have non-GUI meaning; unknown names
are allowed (emit/connect are by-string like g_signal).
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Callable, Dict, List

# the non-GUI core of dt_signal_t (signal.h:56-336)
SIGNALS = (
    "COLLECTION_CHANGED",
    "SELECTION_CHANGED",
    "TAG_CHANGED",
    "IMAGE_IMPORT",
    "IMAGE_REMOVED",
    "FILMROLLS_CHANGED",
    "FILMROLLS_IMPORTED",
    "HISTORY_CHANGED",
    "HISTORY_RESYNC",
    "DEVELOP_IMAGE_CHANGED",
    "DEVELOP_PIPE_FINISHED",
    "JOB_STARTED",
    "JOB_FINISHED",
    "EXPORT_FINISHED",
)


class SignalBus:
    def __init__(self):
        self._handlers: Dict[str, List[Callable]] = defaultdict(list)
        self._lock = threading.Lock()

    def connect(self, name: str, handler: Callable) -> Callable:
        with self._lock:
            self._handlers[name].append(handler)
        return handler

    def disconnect(self, name: str, handler: Callable):
        with self._lock:
            if handler in self._handlers.get(name, []):
                self._handlers[name].remove(handler)

    def emit(self, name: str, **kwargs):
        with self._lock:
            handlers = list(self._handlers.get(name, []))
        for h in handlers:
            h(**kwargs)
