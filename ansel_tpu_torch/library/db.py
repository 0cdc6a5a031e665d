"""SQLite image library (library.db analog; `ansel_tpu/library/db.py`,
copied: the same schema, so a library.db either package writes opens in
the other).

Reference: `ansel/src/common/database.c` (schema v36 tables
:196-298 — film_rolls, images, history, masks_history, history_hash,
module_order, tags, tagged_images, color_labels, meta_data, styles;
stepwise `_upgrade_*` migrations; maintenance/vacuum darktable.c:1324),
`film.c` (folder-based film rolls), `tags.c` (attach/detach),
`history.c` (DB<->pipeline history).

This build keeps the XMP sidecar as the authoritative serialized history
(SURVEY §2.4) — the DB is the *index*: the crawler reconciles both, and
`read_history` re-reads the sidecar when it is newer.  Schema version
is tracked for stepwise migrations like the reference.
"""

from __future__ import annotations

import os
import sqlite3
import time
from typing import List, Sequence

SCHEMA_VERSION = 2

_SCHEMA = """
CREATE TABLE IF NOT EXISTS db_info (key TEXT PRIMARY KEY, value TEXT);
CREATE TABLE IF NOT EXISTS film_rolls (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    access_timestamp INTEGER,
    folder TEXT NOT NULL UNIQUE);
CREATE TABLE IF NOT EXISTS images (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    film_id INTEGER REFERENCES film_rolls(id),
    filename TEXT NOT NULL,
    version INTEGER DEFAULT 0,
    width INTEGER DEFAULT 0, height INTEGER DEFAULT 0,
    maker TEXT DEFAULT '', model TEXT DEFAULT '', lens TEXT DEFAULT '',
    exposure REAL DEFAULT 0, aperture REAL DEFAULT 0,
    iso REAL DEFAULT 0, focal_length REAL DEFAULT 0,
    datetime_taken TEXT DEFAULT '',
    flags INTEGER DEFAULT 0,
    color_labels INTEGER DEFAULT 0,
    import_timestamp INTEGER DEFAULT 0,
    change_timestamp INTEGER DEFAULT 0,
    xmp_timestamp INTEGER DEFAULT 0,
    latitude REAL, longitude REAL, elevation REAL,
    UNIQUE(film_id, filename, version));
CREATE TABLE IF NOT EXISTS history (
    imgid INTEGER REFERENCES images(id),
    num INTEGER,
    operation TEXT, op_params BLOB, module INTEGER,
    enabled INTEGER, blendop_params BLOB,
    multi_priority INTEGER DEFAULT 0, multi_name TEXT DEFAULT '',
    iop_order REAL);
CREATE TABLE IF NOT EXISTS masks_history (
    imgid INTEGER REFERENCES images(id),
    num INTEGER, formid INTEGER, form INTEGER,
    name TEXT, version INTEGER, points BLOB, points_count INTEGER,
    source BLOB);
CREATE TABLE IF NOT EXISTS history_hash (
    imgid INTEGER PRIMARY KEY REFERENCES images(id),
    basic_hash BLOB, current_hash BLOB, mipmap_hash BLOB);
CREATE TABLE IF NOT EXISTS module_order (
    imgid INTEGER PRIMARY KEY REFERENCES images(id),
    version INTEGER, iop_list TEXT);
CREATE TABLE IF NOT EXISTS tags (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT NOT NULL UNIQUE, synonyms TEXT DEFAULT '',
    flags INTEGER DEFAULT 0);
CREATE TABLE IF NOT EXISTS tagged_images (
    imgid INTEGER REFERENCES images(id),
    tagid INTEGER REFERENCES tags(id),
    position INTEGER DEFAULT 0,
    PRIMARY KEY (imgid, tagid));
CREATE TABLE IF NOT EXISTS meta_data (
    id INTEGER REFERENCES images(id),
    key INTEGER, value TEXT,
    PRIMARY KEY (id, key));
CREATE TABLE IF NOT EXISTS styles (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT UNIQUE, description TEXT DEFAULT '');
CREATE TABLE IF NOT EXISTS selected_images (imgid INTEGER PRIMARY KEY);
CREATE INDEX IF NOT EXISTS images_film_idx ON images(film_id);
CREATE INDEX IF NOT EXISTS history_imgid_idx ON history(imgid);
CREATE INDEX IF NOT EXISTS tagged_tag_idx ON tagged_images(tagid);
"""

RAW_EXTS = {".dng", ".cr2", ".cr3", ".nef", ".raf", ".arw", ".orf",
            ".rw2", ".pef", ".srw", ".npz"}
IMG_EXTS = RAW_EXTS | {".jpg", ".jpeg", ".png", ".tif", ".tiff"}

# flags bits (reference image flags; rating in low 3 bits)
FLAG_REJECTED = 0x8


class Library:
    """One library.db connection + the import/tag/history API."""

    def __init__(self, path: str = ":memory:"):
        self.path = path
        if path != ":memory:":
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
        self.con = sqlite3.connect(path)
        self.con.row_factory = sqlite3.Row
        self.con.executescript(_SCHEMA)
        cur = self.con.execute(
            "SELECT value FROM db_info WHERE key='version'")
        row = cur.fetchone()
        if row is None:
            self.con.execute(
                "INSERT INTO db_info (key, value) VALUES ('version', ?)",
                (str(SCHEMA_VERSION),))
        else:
            self._migrate(int(row["value"]))
        self.con.commit()

    def _migrate(self, from_version: int):
        # stepwise migrations like database.c _upgrade_*
        if from_version < 2:
            for col in ("latitude REAL", "longitude REAL",
                        "elevation REAL"):
                try:
                    self.con.execute(
                        f"ALTER TABLE images ADD COLUMN {col}")
                except Exception:
                    pass  # column already present (fresh schema)
            self.con.execute(
                "UPDATE db_info SET value='2' WHERE key='version'")
            from_version = 2
        if from_version > SCHEMA_VERSION:
            raise RuntimeError(
                f"library.db version {from_version} is newer than this "
                f"build ({SCHEMA_VERSION})")

    def close(self):
        self.con.close()

    # --- film rolls + import (film.c) ----------------------------------

    def film_roll(self, folder: str) -> int:
        folder = os.path.abspath(folder)
        cur = self.con.execute(
            "SELECT id FROM film_rolls WHERE folder=?", (folder,))
        row = cur.fetchone()
        if row:
            return row["id"]
        cur = self.con.execute(
            "INSERT INTO film_rolls (access_timestamp, folder) "
            "VALUES (?, ?)", (int(time.time()), folder))
        self.con.commit()
        return cur.lastrowid

    def import_image(self, path: str, version: int = 0) -> int:
        """-> imgid (existing or new); reads EXIF on first import."""
        path = os.path.abspath(path)
        film = self.film_roll(os.path.dirname(path))
        name = os.path.basename(path)
        cur = self.con.execute(
            "SELECT id FROM images WHERE film_id=? AND filename=? "
            "AND version=?", (film, name, version))
        row = cur.fetchone()
        if row:
            return row["id"]
        from ..io.exif import read_exif

        ex = read_exif(path)
        cur = self.con.execute(
            "INSERT INTO images (film_id, filename, version, maker, "
            "model, lens, exposure, aperture, iso, focal_length, "
            "datetime_taken, import_timestamp) "
            "VALUES (?,?,?,?,?,?,?,?,?,?,?,?)",
            (film, name, version, ex.maker, ex.model, ex.lens,
             ex.exposure, ex.aperture, ex.iso, ex.focal_length,
             ex.datetime, int(time.time())))
        self.con.commit()
        return cur.lastrowid

    def import_film_roll(self, folder: str) -> List[int]:
        """Import every image file in `folder` (film.c semantics)."""
        ids = []
        for name in sorted(os.listdir(folder)):
            if os.path.splitext(name)[1].lower() in IMG_EXTS:
                ids.append(self.import_image(os.path.join(folder, name)))
        return ids

    def image_path(self, imgid: int) -> str:
        row = self.con.execute(
            "SELECT f.folder AS folder, i.filename AS filename "
            "FROM images i JOIN film_rolls f ON i.film_id=f.id "
            "WHERE i.id=?", (imgid,)).fetchone()
        if row is None:
            raise KeyError(imgid)
        return os.path.join(row["folder"], row["filename"])

    def xmp_path(self, imgid: int) -> str:
        return self.image_path(imgid) + ".xmp"

    # --- ratings / labels / tags ---------------------------------------

    def set_rating(self, imgid: int, stars: int):
        stars = max(0, min(int(stars), 5))
        self.con.execute(
            "UPDATE images SET flags=(flags & ~7) | ?, "
            "change_timestamp=? WHERE id=?",
            (stars, int(time.time()), imgid))
        self.con.commit()

    def rating(self, imgid: int) -> int:
        row = self.con.execute("SELECT flags FROM images WHERE id=?",
                               (imgid,)).fetchone()
        return (row["flags"] & 7) if row else 0

    def set_color_label(self, imgid: int, color: int, on: bool = True):
        op = "color_labels | ?" if on else "color_labels & ~?"
        self.con.execute(
            f"UPDATE images SET color_labels = {op} WHERE id=?",
            (1 << color, imgid))
        self.con.commit()

    def tag(self, name: str) -> int:
        cur = self.con.execute("SELECT id FROM tags WHERE name=?",
                               (name,))
        row = cur.fetchone()
        if row:
            return row["id"]
        cur = self.con.execute("INSERT INTO tags (name) VALUES (?)",
                               (name,))
        self.con.commit()
        return cur.lastrowid

    def attach_tag(self, imgid: int, name: str):
        tid = self.tag(name)
        self.con.execute(
            "INSERT OR IGNORE INTO tagged_images (imgid, tagid) "
            "VALUES (?, ?)", (imgid, tid))
        self.con.commit()

    def detach_tag(self, imgid: int, name: str):
        self.con.execute(
            "DELETE FROM tagged_images WHERE imgid=? AND tagid="
            "(SELECT id FROM tags WHERE name=?)", (imgid, name))
        self.con.commit()

    def image_tags(self, imgid: int) -> List[str]:
        return [r["name"] for r in self.con.execute(
            "SELECT t.name AS name FROM tags t JOIN tagged_images ti "
            "ON t.id=ti.tagid WHERE ti.imgid=? ORDER BY t.name",
            (imgid,))]

    # --- history (DB index of the authoritative XMP) -------------------

    def write_history(self, imgid: int, history: Sequence,
                      iop_order_version: int = 30):
        """Store decoded HistoryItems into the history table."""
        self.con.execute("DELETE FROM history WHERE imgid=?", (imgid,))
        for num, it in enumerate(history):
            from ..core.params import params_class

            if isinstance(it.params, bytes):
                blob = it.params
            else:
                cls = params_class(it.op, it.version)
                obj = it.params if not isinstance(it.params, dict) \
                    else cls(**it.params)
                blob = cls.codec.encode(obj)
            blend = it.blend_params if isinstance(it.blend_params, bytes) \
                else None
            self.con.execute(
                "INSERT INTO history (imgid, num, operation, op_params, "
                "module, enabled, blendop_params, multi_priority, "
                "iop_order) VALUES (?,?,?,?,?,?,?,?,?)",
                (imgid, num, it.op, blob, it.version or 0,
                 int(it.enabled), blend, it.multi_priority,
                 it.iop_order))
        self.con.execute(
            "INSERT OR REPLACE INTO module_order (imgid, version, "
            "iop_list) VALUES (?, ?, '')", (imgid, iop_order_version))
        self.con.execute(
            "UPDATE images SET change_timestamp=? WHERE id=?",
            (int(time.time()), imgid))
        self.con.commit()

    def read_history(self, imgid: int) -> List:
        from ..pipeline.engine import HistoryItem

        out = []
        for r in self.con.execute(
                "SELECT * FROM history WHERE imgid=? ORDER BY num",
                (imgid,)):
            out.append(HistoryItem(
                r["operation"], params=r["op_params"],
                version=r["module"] or None,
                enabled=bool(r["enabled"]),
                iop_order=r["iop_order"],
                multi_priority=r["multi_priority"] or 0,
                blend_params=r["blendop_params"]))
        return out

    def images(self) -> List[int]:
        return [r["id"] for r in
                self.con.execute("SELECT id FROM images ORDER BY id")]
