"""EXIF metadata reader (TIFF/DNG IFDs + JPEG APP1;
`ansel_tpu/io/exif.py`, copied).

Reference: `ansel/src/common/exif.cc` (exiv2-backed
dt_exif_read, :700-1100 — maker/model/lens, exposure triplet, datetime,
orientation, focal length; consumed by the image table import
`database.c` images columns and `variables.c` $(EXIF_*) expansion).

Pure-python struct parsing: TIFF byte-order header, IFD0 + ExifIFD
walk, rational decoding, with no external metadata library; this
covers the tags the library layer and filename variables need.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 7: 1, 9: 4, 10: 8}

TAG_MAKE = 0x010F
TAG_MODEL = 0x0110
TAG_ORIENTATION = 0x0112
TAG_DATETIME = 0x0132
TAG_EXIF_IFD = 0x8769
TAG_EXPOSURE_TIME = 0x829A
TAG_FNUMBER = 0x829D
TAG_ISO = 0x8827
TAG_DATETIME_ORIGINAL = 0x9003
TAG_FOCAL_LENGTH = 0x920A
TAG_LENS_MODEL = 0xA434


@dataclasses.dataclass
class ExifData:
    maker: str = ""
    model: str = ""
    lens: str = ""
    datetime: str = ""          # "YYYY:MM:DD HH:MM:SS"
    iso: float = 0.0
    exposure: float = 0.0       # seconds
    aperture: float = 0.0       # f-number
    focal_length: float = 0.0   # mm
    orientation: int = 1


def _read_ifd(buf: bytes, offset: int, endian: str):
    """-> dict tag -> value (first element), plus raw entries."""
    out = {}
    if offset + 2 > len(buf):
        return out
    (count,) = struct.unpack_from(endian + "H", buf, offset)
    pos = offset + 2
    for _ in range(count):
        if pos + 12 > len(buf):
            break
        tag, typ, n = struct.unpack_from(endian + "HHI", buf, pos)
        size = _TYPE_SIZES.get(typ, 1) * n
        if size <= 4:
            data_off = pos + 8
        else:
            (data_off,) = struct.unpack_from(endian + "I", buf, pos + 8)
        try:
            if typ == 2:      # ASCII
                raw = buf[data_off:data_off + n]
                out[tag] = raw.split(b"\0")[0].decode("utf-8", "ignore")
            elif typ in (3, 4, 1):
                fmt = {1: "B", 3: "H", 4: "I"}[typ]
                out[tag] = struct.unpack_from(endian + fmt, buf,
                                              data_off)[0]
            elif typ in (5, 10):  # rational
                num, den = struct.unpack_from(
                    endian + ("II" if typ == 5 else "ii"), buf, data_off)
                out[tag] = num / den if den else 0.0
        except (struct.error, UnicodeDecodeError):
            pass
        pos += 12
    return out


def _parse_tiff(buf: bytes) -> Optional[ExifData]:
    if len(buf) < 8:
        return None
    if buf[:2] == b"II":
        endian = "<"
    elif buf[:2] == b"MM":
        endian = ">"
    else:
        return None
    magic, ifd0_off = struct.unpack_from(endian + "HI", buf, 2)
    if magic not in (42, 0x4F52, 0x5352):  # TIFF, ORF variants
        return None
    ifd0 = _read_ifd(buf, ifd0_off, endian)
    exif_ifd = {}
    if TAG_EXIF_IFD in ifd0:
        exif_ifd = _read_ifd(buf, ifd0[TAG_EXIF_IFD], endian)
    merged = {**ifd0, **exif_ifd}
    return ExifData(
        maker=str(merged.get(TAG_MAKE, "")).strip(),
        model=str(merged.get(TAG_MODEL, "")).strip(),
        lens=str(merged.get(TAG_LENS_MODEL, "")).strip(),
        datetime=str(merged.get(TAG_DATETIME_ORIGINAL,
                                merged.get(TAG_DATETIME, ""))),
        iso=float(merged.get(TAG_ISO, 0) or 0),
        exposure=float(merged.get(TAG_EXPOSURE_TIME, 0.0) or 0.0),
        aperture=float(merged.get(TAG_FNUMBER, 0.0) or 0.0),
        focal_length=float(merged.get(TAG_FOCAL_LENGTH, 0.0) or 0.0),
        orientation=int(merged.get(TAG_ORIENTATION, 1) or 1),
    )


def _parse_jpeg(buf: bytes) -> Optional[ExifData]:
    if buf[:2] != b"\xFF\xD8":
        return None
    pos = 2
    while pos + 4 <= len(buf):
        if buf[pos] != 0xFF:
            break
        marker = buf[pos + 1]
        (seglen,) = struct.unpack_from(">H", buf, pos + 2)
        if marker == 0xE1 and buf[pos + 4:pos + 10] == b"Exif\0\0":
            return _parse_tiff(buf[pos + 10:pos + 2 + seglen])
        if marker == 0xDA:  # start of scan
            break
        pos += 2 + seglen
    return None


def read_exif(path: str) -> ExifData:
    """Best-effort EXIF read; returns empty ExifData when unreadable."""
    try:
        with open(path, "rb") as f:
            buf = f.read(4 * 1024 * 1024)
    except OSError:
        return ExifData()
    return _parse_jpeg(buf) or _parse_tiff(buf) or ExifData()
