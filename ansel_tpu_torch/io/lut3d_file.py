"""3D LUT file loaders: .cube (Adobe/IRIDAS), .3dl (Autodesk) and Hald
CLUT images, copied from `ansel_tpu/io/lut3d_file.py`.

Reference: `ansel/src/iop/lut3d.c` lut file parsing (parse_cube,
parse_3dl, the png haldclut path).  The loaders are host numpy; the
(level^3, 3) table goes to the device once as the op's coefficient.

A Hald image is read as the JAX package reads it, through PIL
(`Image.open(path).convert("RGB")`, scaled by 1/255): any form PIL
opens.  Where PIL is not installed, a Hald `.png` is decoded by
`read_png8` (zlib alone): 8-bit RGB or RGBA, not interlaced, filter
types 0-4, scaled by 1/255 as PIL's `convert("RGB")` gives it (alpha
dropped); any other form (a JPEG, a TIFF, a 16-bit, palette, grey or
interlaced PNG) then raises NotImplementedError, which the lut3d op does
not catch, so it never turns into the identity.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from ..ops.base import not_ported


def load_cube(path: str) -> np.ndarray:
    """-> (level, level, level, 3) float32, indexed [b][g][r] like dt's
    flat layout r + g*L + b*L^2."""
    level = None
    rows = []
    domain_min = np.zeros(3)
    domain_max = np.ones(3)
    with open(path, "r", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            key = tok[0].upper()
            if key == "LUT_3D_SIZE":
                level = int(tok[1])
            elif key == "LUT_1D_SIZE":
                raise ValueError("1D LUTs not supported in lut3d")
            elif key == "DOMAIN_MIN":
                domain_min = np.array([float(v) for v in tok[1:4]])
            elif key == "DOMAIN_MAX":
                domain_max = np.array([float(v) for v in tok[1:4]])
            elif key in ("TITLE",):
                continue
            else:
                try:
                    rows.append([float(tok[0]), float(tok[1]), float(tok[2])])
                except (ValueError, IndexError):
                    continue
    if level is None or len(rows) < level ** 3:
        raise ValueError(f"malformed .cube: level={level} rows={len(rows)}")
    data = np.asarray(rows[:level ** 3], np.float32)
    span = np.maximum(domain_max - domain_min, 1e-9)
    data = (data - domain_min) / span
    return data.reshape(level, level, level, 3).astype(np.float32)


def load_3dl(path: str) -> np.ndarray:
    """Autodesk .3dl: first non-comment line is the mesh, then R-fastest
    integer rows scaled by the max code value."""
    rows = []
    mesh = None
    with open(path, "r", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            vals = []
            try:
                vals = [float(v) for v in tok]
            except ValueError:
                continue
            if mesh is None:
                mesh = vals  # the shaper/mesh line
                continue
            if len(vals) >= 3:
                rows.append(vals[:3])
    if mesh is None:
        raise ValueError("malformed .3dl: no mesh line")
    level = int(round(len(rows) ** (1.0 / 3.0)))
    if level ** 3 != len(rows):
        raise ValueError(f"malformed .3dl: {len(rows)} rows")
    data = np.asarray(rows, np.float32)
    maxcode = float(data.max())
    # common encodings: 10-bit (1023), 12-bit (4095), 16-bit
    for full in (1023.0, 4095.0, 65535.0):
        if maxcode <= full:
            data = data / full
            break
    # .3dl is blue-fastest: reorder to r-fastest
    data = data.reshape(level, level, level, 3)  # [r][g][b]
    data = np.transpose(data, (2, 1, 0, 3))      # -> [b][g][r]
    return np.ascontiguousarray(data, np.float32)


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the PNG scanline filters (types 0-4) -> (h, w * bpp) uint8."""
    stride = w * bpp
    if len(raw) < h * (stride + 1):
        raise ValueError("PNG image data is truncated")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(
        h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:   # Sub: a running sum per byte of a pixel, mod 256
            cur = np.cumsum(line.reshape(w, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == 2:   # Up
            cur = line + prev
        elif ftype in (3, 4):  # Average, Paeth: each byte reads its left
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
                    continue
                c = up[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def read_png8(path: str) -> np.ndarray:
    """An 8-bit RGB or RGBA, non-interlaced PNG -> (H, W, 3 or 4) uint8.
    Raises ValueError for a file that is not a PNG or is damaged, and
    NotImplementedError for a PNG of another form."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        (n,) = struct.unpack_from(">I", data, pos)
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in (2, 6) or interlace != 0:
        raise not_ported("lut3d_file.read_png8",
                         f"a PNG of bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace} (only 8-bit RGB or RGBA, "
                         "not interlaced)")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: {e}") from e
    bpp = 3 if ctype == 2 else 4
    return _unfilter(raw, h, w, bpp).reshape(h, w, bpp)


def pil_image():
    """PIL's `Image` module, or None where PIL is not installed."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def load_hald(path: str) -> np.ndarray:
    """Hald CLUT image: an NxN image where N = level^1.5 (level = k^2)."""
    Image = pil_image()
    if Image is not None:
        img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    elif os.path.splitext(path)[1].lower() != ".png":
        os.stat(path)  # a missing file is an OSError, as PIL's open gives
        raise not_ported("lut3d", "a Hald CLUT image other than an 8-bit "
                         "RGB or RGBA PNG without PIL")
    else:
        img = np.asarray(read_png8(path)[..., :3], np.float32) / 255.0
    n = img.shape[0]
    level = int(round(n ** (2.0 / 3.0)))
    if level ** 3 != n * n or img.shape[1] != n:
        raise ValueError(f"not a Hald CLUT: {img.shape}")
    return img.reshape(level, level, level, 3).astype(np.float32)


def load_lut3d(path: str) -> np.ndarray:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".cube":
        return load_cube(path)
    if ext == ".3dl":
        return load_3dl(path)
    if ext in (".png", ".jpg", ".jpeg", ".tif", ".tiff"):
        return load_hald(path)
    raise ValueError(f"unsupported 3D LUT format: {ext}")
