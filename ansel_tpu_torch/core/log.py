"""Structured logging: leveled, per-domain debug channels.

Reference: `ansel/src/common/logging.{c,h}` (dt_print with
DT_DEBUG_* domain flags set by `-d <domain>`) — the observability layer
VERDICT flagged (§5.5).  Domains mirror the reference's (-d perf, -d
opencl -> 'device', -d pipe, ...); records go to stderr and an optional
in-memory ring for tests/tools.
"""

from __future__ import annotations

import collections
import sys
import threading
import time
from typing import Deque, Tuple

DOMAINS = ("always", "perf", "pipe", "device", "library", "control",
           "nan", "params", "memory")

_enabled = {"always"}
_ring: Deque[Tuple[float, str, str]] = collections.deque(maxlen=1000)
_lock = threading.Lock()
_t0 = time.monotonic()


def enable(*domains: str):
    """dt_init's `-d <domain>` analog."""
    with _lock:
        for d in domains:
            _enabled.add(d)


def disable(*domains: str):
    with _lock:
        for d in domains:
            _enabled.discard(d)


def enabled(domain: str) -> bool:
    return domain in _enabled


def log(domain: str, msg: str, **fields):
    """One structured record; printed only when the domain is enabled,
    always kept in the ring buffer."""
    ts = time.monotonic() - _t0
    if fields:
        msg = msg + " " + " ".join(f"{k}={v}" for k, v in fields.items())
    with _lock:
        _ring.append((ts, domain, msg))
        show = domain in _enabled
    if show:
        print(f"[{ts:9.3f}s] [{domain}] {msg}", file=sys.stderr)


def records(domain: str = None):
    with _lock:
        return [r for r in _ring if domain is None or r[1] == domain]


def clear():
    with _lock:
        _ring.clear()
