"""XMP crawler: reconcile the library DB against sidecar files
(`ansel_tpu/library/crawler.py`, through the port's `io/xmp.py`).

Reference: `ansel/src/control/crawler.c` (startup scan
comparing each image's DB change timestamp vs its sidecar mtime; newer
sidecars re-import history into the DB, run at dt_init
darktable.c:1341-1345).  The sidecar stays authoritative (SURVEY §2.4):
DB-newer images can be flushed back out with `write_back=True`.  A
Lightroom-authored sidecar is imported through `io/lightroom.py`: its
history, rating and tags go to the library.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List

from .db import Library


@dataclasses.dataclass
class CrawlReport:
    reimported: List[int] = dataclasses.field(default_factory=list)
    written_back: List[int] = dataclasses.field(default_factory=list)
    missing_files: List[int] = dataclasses.field(default_factory=list)


def crawl(lib: Library, write_back: bool = False) -> CrawlReport:
    """Scan every image; sync history with its sidecar by timestamp."""
    from ..io.xmp import parse_xmp

    from ..core import log as log_mod

    report = CrawlReport()
    for imgid in lib.images():
        try:
            img_path = lib.image_path(imgid)
        except KeyError:
            continue
        if not os.path.exists(img_path):
            report.missing_files.append(imgid)
            continue
        xmp = lib.xmp_path(imgid)
        row = lib.con.execute(
            "SELECT change_timestamp, xmp_timestamp FROM images "
            "WHERE id=?", (imgid,)).fetchone()
        if os.path.exists(xmp):
            mtime = int(os.stat(xmp).st_mtime)
            if mtime > (row["xmp_timestamp"] or 0):
                with open(xmp, "r", encoding="utf-8",
                          errors="replace") as fh:
                    text = fh.read()
                from ..io.lightroom import (is_lightroom_xmp,
                                            parse_lightroom_xmp)

                if is_lightroom_xmp(text):
                    # LR-authored sidecar (develop/lightroom.c import)
                    imp = parse_lightroom_xmp(text)
                    lib.write_history(imgid, imp.history)
                    if imp.rating is not None:
                        lib.set_rating(imgid, imp.rating)
                    for tag in imp.tags:
                        lib.attach_tag(imgid, tag)
                else:
                    doc = parse_xmp(xmp)
                    lib.write_history(imgid, doc.history)
                lib.con.execute(
                    "UPDATE images SET xmp_timestamp=? WHERE id=?",
                    (mtime, imgid))
                lib.con.commit()
                report.reimported.append(imgid)
                log_mod.log("library", "crawler reimported sidecar",
                            imgid=imgid)
                continue
        if write_back and (row["change_timestamp"] or 0) \
                > (row["xmp_timestamp"] or 0):
            from ..io.xmp import XMPDocument, write_xmp

            hist = lib.read_history(imgid)
            if hist:
                write_xmp(xmp, XMPDocument(history=hist))
                lib.con.execute(
                    "UPDATE images SET xmp_timestamp=? WHERE id=?",
                    (int(os.stat(xmp).st_mtime), imgid))
                lib.con.commit()
                report.written_back.append(imgid)
    return report
