"""Crash handling: fault tracebacks + processing breadcrumbs (a copy of
`ansel_tpu/core/crash.py`).

Behavioral reference: `ansel/src/common/system_signal_handling.c`
(signal handlers that dump a gdb backtrace on SIGSEGV/SIGABRT) and the
pipeline crash breadcrumbs (`pixelpipe_hb.c:1380-1393` records which
image/pipe was being processed so a crash report names the culprit).

Python's `faulthandler` dumps all-thread tracebacks on fatal signals
(the gdb-backtrace analog, covering native crashes in the CUDA
libraries too), and a process-global breadcrumb dict
records the current image/pipe; an excepthook prints the breadcrumbs on
any unhandled exception so headless batch logs name the failing image.
Sentry/telemetry upload is out of scope (docs/PARITY.md waiver) — the
report surface is stderr/file, not a crash service.
"""

from __future__ import annotations

import atexit
import faulthandler
import sys
import threading
from typing import Any, Dict, Optional

_BREADCRUMBS: Dict[str, Any] = {}
_LOCK = threading.Lock()
_INSTALLED = False
_LOG_FILE = None


def breadcrumb(key: str, value: Any):
    """Record what is being processed (image path, pipe type, stage)
    — pixelpipe_hb.c:1380-1393 semantics."""
    with _LOCK:
        if value is None:
            _BREADCRUMBS.pop(key, None)
        else:
            _BREADCRUMBS[key] = value


def breadcrumbs() -> Dict[str, Any]:
    with _LOCK:
        return dict(_BREADCRUMBS)


def _print_breadcrumbs(stream):
    bc = breadcrumbs()
    if bc:
        print("[crash] processing context: "
              + ", ".join(f"{k}={v}" for k, v in sorted(bc.items())),
              file=stream)


def install(log_path: Optional[str] = None):
    """Enable fault tracebacks (SIGSEGV/SIGFPE/SIGABRT/SIGBUS) and the
    unhandled-exception breadcrumb report.  Idempotent."""
    global _INSTALLED, _LOG_FILE
    if _INSTALLED:
        return
    _INSTALLED = True
    stream = sys.stderr
    if log_path:
        _LOG_FILE = open(log_path, "a")
        stream = _LOG_FILE
        atexit.register(_LOG_FILE.close)
    faulthandler.enable(file=stream, all_threads=True)

    prev_hook = sys.excepthook

    def hook(tp, val, tb):
        _print_breadcrumbs(sys.stderr)
        prev_hook(tp, val, tb)

    sys.excepthook = hook
