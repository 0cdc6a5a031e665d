"""Collection queries: the library's SQL filter builder
(`ansel_tpu/library/collections.py`, copied).

Reference: `ansel/src/common/collection.c` (:300-900 —
per-property WHERE clause composition for film roll, tags, ratings,
color labels, camera, lens, ISO/aperture/focal ranges, date taken,
filename; sort orders dt_collection_sort_t).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from .db import Library

SORT_FILENAME = "filename"
SORT_DATETIME = "datetime"
SORT_RATING = "rating"
SORT_ID = "id"


@dataclasses.dataclass
class Collection:
    """Filter set; every field is AND-combined like the reference's
    collection rules."""

    film_folder: Optional[str] = None
    tag: Optional[str] = None
    min_rating: int = 0
    rejected: Optional[bool] = None
    color_label: Optional[int] = None
    camera: Optional[str] = None          # substring of maker+model
    lens: Optional[str] = None
    iso: Optional[Tuple[float, float]] = None
    aperture: Optional[Tuple[float, float]] = None
    focal: Optional[Tuple[float, float]] = None
    taken_after: Optional[str] = None     # "YYYY:MM:DD..." prefix compare
    taken_before: Optional[str] = None
    filename_like: Optional[str] = None
    sort: str = SORT_ID
    descending: bool = False

    def query(self) -> Tuple[str, list]:
        where, args = ["1=1"], []
        if self.film_folder is not None:
            where.append(
                "i.film_id IN (SELECT id FROM film_rolls WHERE "
                "folder LIKE ?)")
            args.append(self.film_folder)
        if self.tag is not None:
            where.append(
                "i.id IN (SELECT imgid FROM tagged_images ti JOIN tags t "
                "ON ti.tagid=t.id WHERE t.name=?)")
            args.append(self.tag)
        if self.min_rating > 0:
            where.append("(i.flags & 7) >= ?")
            args.append(self.min_rating)
        if self.rejected is not None:
            where.append("(i.flags & 8) " + ("!= 0" if self.rejected
                                             else "= 0"))
        if self.color_label is not None:
            where.append("(i.color_labels & ?) != 0")
            args.append(1 << self.color_label)
        if self.camera is not None:
            where.append("(i.maker || ' ' || i.model) LIKE ?")
            args.append(f"%{self.camera}%")
        if self.lens is not None:
            where.append("i.lens LIKE ?")
            args.append(f"%{self.lens}%")
        for field, rng in (("iso", self.iso), ("aperture", self.aperture),
                           ("focal_length", self.focal)):
            if rng is not None:
                where.append(f"i.{field} BETWEEN ? AND ?")
                args.extend(rng)
        if self.taken_after is not None:
            where.append("i.datetime_taken >= ?")
            args.append(self.taken_after)
        if self.taken_before is not None:
            where.append("i.datetime_taken <= ?")
            args.append(self.taken_before)
        if self.filename_like is not None:
            where.append("i.filename LIKE ?")
            args.append(self.filename_like)
        order = {SORT_FILENAME: "i.filename",
                 SORT_DATETIME: "i.datetime_taken",
                 SORT_RATING: "(i.flags & 7)",
                 SORT_ID: "i.id"}[self.sort]
        sql = ("SELECT i.id FROM images i WHERE "
               + " AND ".join(where)
               + f" ORDER BY {order}" + (" DESC" if self.descending
                                         else ""))
        return sql, args

    def run(self, lib: Library) -> List[int]:
        sql, args = self.query()
        return [r["id"] for r in lib.con.execute(sql, args)]
