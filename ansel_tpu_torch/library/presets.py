"""Module presets with auto-apply rules (`ansel_tpu/library/presets.py`,
copied; the blobs through the port's `core/params.params_class`).

Reference: `ansel/src/common/presets.c` + the data.db presets
table (`database.c`): per-module parameter presets keyed by name, with
auto-apply match rules (maker/model substrings, ISO / aperture / focal
ranges) merged into the history at read time
(`dev_read_history`'s auto-preset pass).
"""

from __future__ import annotations

from typing import List, Optional

from .db import Library

_SCHEMA = """
CREATE TABLE IF NOT EXISTS presets (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT NOT NULL,
    operation TEXT NOT NULL,
    op_version INTEGER,
    op_params BLOB,
    blendop_params BLOB,
    enabled INTEGER DEFAULT 1,
    autoapply INTEGER DEFAULT 0,
    maker TEXT DEFAULT '%', model TEXT DEFAULT '%',
    iso_min REAL DEFAULT 0, iso_max REAL DEFAULT 1e9,
    aperture_min REAL DEFAULT 0, aperture_max REAL DEFAULT 1e9,
    focal_min REAL DEFAULT 0, focal_max REAL DEFAULT 1e9,
    UNIQUE(name, operation));
"""


def _ensure(lib: Library):
    lib.con.executescript(_SCHEMA)


def save_preset(lib: Library, name: str, operation: str, params,
                version: Optional[int] = None, autoapply: bool = False,
                maker: str = "%", model: str = "%",
                iso: tuple = (0.0, 1e9), aperture: tuple = (0.0, 1e9),
                focal: tuple = (0.0, 1e9)):
    """Store one module preset (params: dataclass, dict, or bytes)."""
    from ..core.params import params_class

    _ensure(lib)
    if isinstance(params, bytes):
        blob = params
    else:
        cls = params_class(operation, version)
        obj = cls(**params) if isinstance(params, dict) else params
        blob = cls.codec.encode(obj)
        version = version or getattr(obj, "op_version", None)
    lib.con.execute(
        "INSERT OR REPLACE INTO presets (name, operation, op_version, "
        "op_params, autoapply, maker, model, iso_min, iso_max, "
        "aperture_min, aperture_max, focal_min, focal_max) "
        "VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?)",
        (name, operation, version, blob, int(autoapply), maker, model,
         iso[0], iso[1], aperture[0], aperture[1], focal[0], focal[1]))
    lib.con.commit()


def load_preset(lib: Library, name: str, operation: str):
    _ensure(lib)
    row = lib.con.execute(
        "SELECT * FROM presets WHERE name=? AND operation=?",
        (name, operation)).fetchone()
    if row is None:
        return None
    from ..pipeline.engine import HistoryItem

    return HistoryItem(row["operation"], params=row["op_params"],
                       version=row["op_version"],
                       blend_params=row["blendop_params"])


def auto_presets(lib: Library, imgid: int) -> List:
    """Presets whose match rules fit this image's EXIF
    (presets.c dt_presets_autoapply_for_module)."""
    _ensure(lib)
    img = lib.con.execute("SELECT * FROM images WHERE id=?",
                          (imgid,)).fetchone()
    if img is None:
        return []
    from ..pipeline.engine import HistoryItem

    out = []
    for row in lib.con.execute(
            "SELECT * FROM presets WHERE autoapply=1 AND "
            "? LIKE maker AND ? LIKE model AND "
            "? BETWEEN iso_min AND iso_max AND "
            "? BETWEEN aperture_min AND aperture_max AND "
            "? BETWEEN focal_min AND focal_max",
            (img["maker"] or "", img["model"] or "",
             img["iso"] or 0.0, img["aperture"] or 0.0,
             img["focal_length"] or 0.0)):
        out.append(HistoryItem(row["operation"], params=row["op_params"],
                               version=row["op_version"],
                               blend_params=row["blendop_params"]))
    return out


def apply_auto_presets(lib: Library, imgid: int, history: List) -> List:
    """Prepend matching auto presets for modules absent from history
    (the reference's read-time auto-apply pass)."""
    present = {h.op for h in history}
    extra = [h for h in auto_presets(lib, imgid) if h.op not in present]
    return extra + list(history)
