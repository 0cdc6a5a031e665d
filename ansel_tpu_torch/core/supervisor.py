"""Supervisor — hash-keyed object-lifecycle registry (debug rail), a copy
of `ansel_tpu/core/supervisor.py`.

Behavioral reference: `ansel/src/develop/supervisor.{c,h}`
(doc/supervisor.md): gated by `-d supervisor`, a registry keyed by the
content hashes pipeline objects already carry; one NDJSON line per CRUD
event with links resolved; entries are never removed, so a CREATE or
READ on a hash that was marked dead is flagged `"resurrected": true` —
a use-after-free detector for the hash-declared concurrency model
(supervisor.h:36-75; hooks at pixelpipe_hb.c:618-623, 1204-1210).

As in the JAX package, the supervised surface is the plan/cache layer
this package hand-manages: the pipe cache keyed by
`Pipeline.signature()` (`pipeline/engine._PIPE_CACHE`: "create" for a
new signature, "read" for a repeat).  The raster-mask and mipmap
events come with the modules that own them.

Events are NDJSON lines (one dict per line) in an in-memory ring +
optional file (conf `debug.supervisor_file`), enabled by conf
`debug.supervisor` or `ANSEL_TPU_DEBUG_SUPERVISOR=1`.  Disabled, every
hook is a single boolean check.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, Optional

from . import conf

_LOCK = threading.Lock()
_REGISTRY: Dict[str, Dict[str, Any]] = {}   # key -> {state, kind}
_RING: list = []
_RING_MAX = 4096
_FILE = None
_ENABLED: Optional[bool] = None


def enabled() -> bool:
    global _ENABLED
    if _ENABLED is None:
        _ENABLED = bool(conf.get_bool("debug.supervisor", False))
    return _ENABLED


def _reset_for_tests(on: bool = False):
    global _ENABLED, _FILE
    with _LOCK:
        _REGISTRY.clear()
        _RING.clear()
        _ENABLED = on
        _FILE = None


def _emit(rec: Dict[str, Any]):
    global _FILE
    rec["t"] = round(time.time(), 6)
    line = json.dumps(rec, sort_keys=True, default=str)
    _RING.append(rec)
    if len(_RING) > _RING_MAX:
        del _RING[: _RING_MAX // 4]
    path = conf.get("debug.supervisor_file", "")
    if path:
        if _FILE is None:
            _FILE = open(path, "a")
        _FILE.write(line + "\n")
        _FILE.flush()


def event(kind: str, op: str, key: Any, links: Optional[Dict] = None,
          **extra):
    """Record one CRUD event.  kind: object class (pipe/stage/
    raster_mask/mipmap); op: create|read|update|dead; key: the content
    hash / signature the object carries (reference supervisor.h:40).

    Like the reference, entries are never removed: create/read on a
    key previously marked dead is flagged resurrected=true."""
    if not enabled():
        return
    k = f"{kind}:{key}"
    with _LOCK:
        ent = _REGISTRY.get(k)
        rec = {"kind": kind, "op": op, "key": str(key)}
        if links:
            rec["links"] = {a: str(b) for a, b in links.items()}
        rec.update(extra)
        if op == "create":
            if ent is not None and ent["state"] == "dead":
                rec["resurrected"] = True
            elif ent is not None and ent["state"] == "live":
                rec["duplicate"] = True
            _REGISTRY[k] = {"state": "live", "kind": kind}
        elif op in ("read", "update"):
            if ent is None:
                rec["unknown"] = True
            elif ent["state"] == "dead":
                rec["resurrected"] = True
        elif op == "dead":
            if ent is None:
                rec["unknown"] = True
            _REGISTRY[k] = {"state": "dead", "kind": kind}
        _emit(rec)


def anomalies() -> list:
    """All flagged events in the ring (resurrected/duplicate/unknown) —
    the supervisor's report surface (reference: grep the NDJSON)."""
    with _LOCK:
        return [r for r in _RING
                if r.get("resurrected") or r.get("duplicate")
                or r.get("unknown")]


def ring() -> list:
    with _LOCK:
        return list(_RING)
