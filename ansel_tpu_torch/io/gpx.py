"""GPX track parsing + image geotagging (`ansel_tpu/io/gpx.py`, copied).

Reference: `ansel/src/common/gpx.c` (track point/segment
parse, per-image lookup `dt_gpx_get_location` interpolating the two
track points bracketing the image timestamp) and the geotagging job
that writes latitude/longitude onto images.
"""

from __future__ import annotations

import bisect
import dataclasses
import datetime as _dt
import xml.etree.ElementTree as etree
from typing import List, Optional, Tuple


@dataclasses.dataclass
class TrackPoint:
    t: float          # unix seconds (UTC)
    lat: float
    lon: float
    ele: float = 0.0


def _parse_time(s: str) -> Optional[float]:
    s = s.strip()
    try:
        if s.endswith("Z"):
            s = s[:-1] + "+00:00"
        return _dt.datetime.fromisoformat(s).timestamp()
    except ValueError:
        return None


def parse_gpx(path: str) -> List[TrackPoint]:
    """All track points of all segments, time-sorted (gpx.c parse)."""
    tree = etree.parse(path)
    root = tree.getroot()
    ns = ""
    if root.tag.startswith("{"):
        ns = root.tag[: root.tag.index("}") + 1]
    pts = []
    for trkpt in root.iter(f"{ns}trkpt"):
        lat = float(trkpt.get("lat", "nan"))
        lon = float(trkpt.get("lon", "nan"))
        te = trkpt.find(f"{ns}time")
        t = _parse_time(te.text) if te is not None and te.text else None
        if t is None:
            continue
        ee = trkpt.find(f"{ns}ele")
        ele = float(ee.text) if ee is not None and ee.text else 0.0
        pts.append(TrackPoint(t=t, lat=lat, lon=lon, ele=ele))
    pts.sort(key=lambda p: p.t)
    return pts


def locate(pts: List[TrackPoint], when: float,
           max_gap: float = 3600.0) -> Optional[Tuple[float, float, float]]:
    """(lat, lon, ele) interpolated between the bracketing track points
    (dt_gpx_get_location), or None when outside the track / gap too
    large."""
    if not pts:
        return None
    times = [p.t for p in pts]
    i = bisect.bisect_left(times, when)
    if i == 0:
        p = pts[0]
        return (p.lat, p.lon, p.ele) if p.t - when <= max_gap else None
    if i >= len(pts):
        p = pts[-1]
        return (p.lat, p.lon, p.ele) if when - p.t <= max_gap else None
    a, b = pts[i - 1], pts[i]
    if b.t - a.t > max_gap:
        return None
    f = 0.0 if b.t == a.t else (when - a.t) / (b.t - a.t)
    return (a.lat + f * (b.lat - a.lat), a.lon + f * (b.lon - a.lon),
            a.ele + f * (b.ele - a.ele))


def geotag_images(lib, gpx_path: str, imgids=None, tz_offset: float = 0.0):
    """Apply a GPX track to library images by datetime_taken
    (the reference's geotagging apply job) -> {imgid: (lat, lon, ele)}."""
    pts = parse_gpx(gpx_path)
    out = {}
    rows = lib.con.execute(
        "SELECT id, datetime_taken FROM images" +
        ("" if imgids is None else
         f" WHERE id IN ({','.join('?' * len(imgids))})"),
        tuple(imgids or ())).fetchall()
    for row in rows:
        ts = row["datetime_taken"]
        if not ts:
            continue
        try:
            when = _dt.datetime.strptime(
                ts, "%Y:%m:%d %H:%M:%S").replace(
                tzinfo=_dt.timezone.utc).timestamp() - tz_offset
        except ValueError:
            continue
        loc = locate(pts, when)
        if loc is None:
            continue
        lib.con.execute(
            "UPDATE images SET latitude=?, longitude=?, elevation=? "
            "WHERE id=?", (loc[0], loc[1], loc[2], row["id"]))
        out[row["id"]] = loc
    lib.con.commit()
    return out
