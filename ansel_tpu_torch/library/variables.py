"""$(VARIABLE) filename-template expansion for export
(`ansel_tpu/library/variables.py`, copied).

Reference: `ansel/src/common/variables.c` (:200-900 —
dt_variables_expand: $(ROLL_NAME), $(FILE_*), $(ID)/$(VERSION)/
$(SEQUENCE), date parts, $(EXIF_*) incl. date parts and the exposure
triplet, $(MAKER)/$(MODEL)/$(LENS), $(TITLE)/$(CREATOR) metadata).
Supports the reference's `$(VAR)` syntax; unknown variables expand to
empty like the reference.
"""

from __future__ import annotations

import datetime
import os
import re
from typing import Optional

from .db import Library

_VAR_RE = re.compile(r"\$\(([A-Z_0-9]+)\)")


def _exif_parts(dt_str: str):
    m = re.match(r"(\d{4}):(\d{2}):(\d{2})[ T](\d{2}):(\d{2}):(\d{2})",
                 dt_str or "")
    if not m:
        return ("", "", "", "", "", "")
    return m.groups()


def expand(template: str, lib: Optional[Library] = None,
           imgid: Optional[int] = None, sequence: int = 0,
           extra: Optional[dict] = None) -> str:
    """Expand a filename template for one image."""
    row = None
    folder = ""
    if lib is not None and imgid is not None:
        row = lib.con.execute(
            "SELECT i.*, f.folder AS folder FROM images i JOIN "
            "film_rolls f ON i.film_id=f.id WHERE i.id=?",
            (imgid,)).fetchone()
        folder = row["folder"] if row else ""
    now = datetime.datetime.now()
    fname = row["filename"] if row else ""
    base, ext = os.path.splitext(fname)
    ey, em, ed, eh, emin, es = _exif_parts(
        row["datetime_taken"] if row else "")

    vals = {
        "ROLL_NAME": os.path.basename(folder),
        "FILE_FOLDER": folder,
        "FILE_NAME": base,
        "FILE_EXTENSION": ext.lstrip("."),
        "ID": str(row["id"]) if row else "",
        "VERSION": str(row["version"]) if row else "0",
        "SEQUENCE": f"{sequence:04d}",
        "YEAR": f"{now.year:04d}", "MONTH": f"{now.month:02d}",
        "DAY": f"{now.day:02d}", "HOUR": f"{now.hour:02d}",
        "MINUTE": f"{now.minute:02d}", "SECOND": f"{now.second:02d}",
        "EXIF_YEAR": ey, "EXIF_MONTH": em, "EXIF_DAY": ed,
        "EXIF_HOUR": eh, "EXIF_MINUTE": emin, "EXIF_SECOND": es,
        "EXIF_ISO": str(int(row["iso"])) if row and row["iso"] else "",
        "EXIF_EXPOSURE": (_fmt_exposure(row["exposure"])
                          if row and row["exposure"] else ""),
        "EXIF_APERTURE": (f"{row['aperture']:.1f}"
                          if row and row["aperture"] else ""),
        "EXIF_FOCAL_LENGTH": (str(int(row["focal_length"]))
                              if row and row["focal_length"] else ""),
        "MAKER": row["maker"] if row else "",
        "MODEL": row["model"] if row else "",
        "LENS": row["lens"] if row else "",
        "STARS": str(row["flags"] & 7) if row else "0",
    }
    if lib is not None and imgid is not None:
        for key, name in ((0, "TITLE"), (1, "DESCRIPTION"),
                          (2, "CREATOR"), (3, "PUBLISHER"),
                          (4, "RIGHTS")):
            r = lib.con.execute(
                "SELECT value FROM meta_data WHERE id=? AND key=?",
                (imgid, key)).fetchone()
            vals[name] = r["value"] if r else ""
    if extra:
        vals.update(extra)
    return _VAR_RE.sub(lambda m: vals.get(m.group(1), ""), template)


def _fmt_exposure(seconds: float) -> str:
    if seconds >= 1.0:
        return f"{seconds:.0f}"
    return f"1_{round(1.0 / seconds)}" if seconds > 0 else ""
