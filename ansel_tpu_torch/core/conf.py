"""Config system: typed key/value store with file + env overrides.

Reference: `ansel/src/common/conf.{c,h}` (dt_conf_get_* /
dt_conf_set_* over anselrc; defaults registered at init; string/int/
float/bool types; `--conf key=value` command-line overrides).

Resolution order (highest wins): runtime set() > environment
(`ANSEL_TPU_<KEY>` with dots as underscores) > config file (anselrc
format, `key=value` lines) > registered default.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional

_DEFAULTS: Dict[str, Any] = {}
_FILE: Dict[str, str] = {}
_RUNTIME: Dict[str, Any] = {}
_LOCK = threading.Lock()
_LOADED_PATH: Optional[str] = None


def register(key: str, default: Any, doc: str = ""):
    """Register a default (dt_conf init tables)."""
    _DEFAULTS.setdefault(key, default)
    return default


def load_file(path: Optional[str] = None):
    """Read an anselrc-style file (key=value per line, # comments)."""
    global _LOADED_PATH
    path = path or os.environ.get(
        "ANSEL_TPU_CONF",
        os.path.join(os.path.expanduser("~"), ".config", "ansel_tpu",
                     "ansel_tpurc"))
    _LOADED_PATH = path
    if not os.path.exists(path):
        return
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            k, v = line.split("=", 1)
            _FILE[k.strip()] = v.strip()


def save_file(path: Optional[str] = None):
    path = path or _LOADED_PATH
    if path is None:
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    merged = dict(_FILE)
    merged.update({k: str(v) for k, v in _RUNTIME.items()})
    with open(path, "w", encoding="utf-8") as f:
        for k in sorted(merged):
            f.write(f"{k}={merged[k]}\n")


def _coerce(raw: Any, like: Any):
    if like is None or isinstance(raw, type(like)):
        return raw
    if isinstance(like, bool):
        return str(raw).strip().lower() in ("1", "true", "yes", "on")
    if isinstance(like, int):
        return int(float(raw))
    if isinstance(like, float):
        return float(raw)
    return str(raw)


def get(key: str, default: Any = None) -> Any:
    """Typed lookup through runtime > env > file > default."""
    with _LOCK:
        base = _DEFAULTS.get(key, default)
        if key in _RUNTIME:
            return _coerce(_RUNTIME[key], base)
        env = os.environ.get("ANSEL_TPU_" + key.upper().replace(".", "_"))
        if env is not None:
            return _coerce(env, base)
        if key in _FILE:
            return _coerce(_FILE[key], base)
        return base


def set(key: str, value: Any):  # noqa: A001 - mirrors dt_conf_set
    with _LOCK:
        _RUNTIME[key] = value


def get_bool(key: str, default: bool = False) -> bool:
    return bool(_coerce(get(key, default), True))


def get_int(key: str, default: int = 0) -> int:
    return int(_coerce(get(key, default), 1))


def get_float(key: str, default: float = 0.0) -> float:
    return float(_coerce(get(key, default), 1.0))


def keys():
    with _LOCK:
        out = dict(_DEFAULTS)
        out.update(_FILE)
        out.update(_RUNTIME)
        return sorted(out)


# core defaults (the flags previously buried as module globals)
register("pipe.disable_fusion", False,
         "debug: skip the Pallas pointwise fusion engine")
register("pipe.compile_cache", True, "memoize compiled pipes")
register("library.cache_dir", "", "mipmap cache directory override")
register("control.workers", 4, "generic worker thread count")
register("debug.perf", False, "-d perf: per-stage timing")
register("debug.nan", False, "-d nan: per-stage NaN scan")
