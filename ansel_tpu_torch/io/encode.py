"""Output encoding: display-referred float planes -> 8/16-bit images with
ICC profile + EXIF embedding.

Reference: `ansel/src/imageio/imageio_core.c:897-928` (float ->
uint8/16 conversion under the read lock) + format plugins
(`src/imageio/format/{jpeg,png,tiff}.c` — all three embed the output ICC
profile and carry EXIF over via exiv2).  Here:

  * uint8 JPEG/PNG/TIFF/WebP via PIL with `icc_profile=` + `exif=`.
  * 16-bit: PIL can't write 16-bit RGB PNGs, so `_write_png16` emits the
    PNG stream directly (zlib, filter 0, big-endian — png.c:16-bit path)
    and `_write_tiff16` a minimal uncompressed little-endian TIFF
    (tiff.c:16-bit path), both with embedded ICC (PNG `iCCP` chunk /
    TIFF tag 34675).
  * PFM/PPM float & 16-bit variants (format/pnm.c).
"""

from __future__ import annotations

import functools
import struct
import zlib
from typing import Optional

import numpy as np


@functools.lru_cache(maxsize=1)
def srgb_icc_bytes() -> bytes:
    """Standard sRGB ICC profile (LCMS-built, like colorout's default),
    built once a process: LCMS stamps a profile with the time it was
    made, so that every file a process writes carries the same bytes."""
    from PIL import ImageCms

    return ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).tobytes()


def exif_from_meta(meta) -> Optional[bytes]:
    """Minimal EXIF carry-over from RawMeta (maker/model/ISO)."""
    try:
        from PIL import Image

        ex = Image.Exif()
        if getattr(meta, "maker", ""):
            ex[271] = str(meta.maker)          # Make
        if getattr(meta, "model", ""):
            ex[272] = str(meta.model)          # Model
        iso = int(getattr(meta, "iso", 0) or 0)
        if iso:
            ex[34855] = iso                     # ISOSpeedRatings
        ex[305] = "ansel_tpu"                   # Software
        return ex.tobytes()
    except Exception:
        return None


def to_uint8(img_chw: np.ndarray) -> np.ndarray:
    """(3,H,W) display-referred [0,1] -> (H,W,3) uint8 with rounding."""
    x = np.clip(np.asarray(img_chw), 0.0, 1.0)
    return (x * 255.0 + 0.5).astype(np.uint8).transpose(1, 2, 0)


def to_uint16(img_chw: np.ndarray) -> np.ndarray:
    x = np.clip(np.asarray(img_chw), 0.0, 1.0)
    return (x * 65535.0 + 0.5).astype(np.uint16).transpose(1, 2, 0)


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def _write_png16(path: str, arr: np.ndarray, icc: Optional[bytes]) -> None:
    """(H, W, 3) uint16 -> 16-bit RGB PNG (big-endian, filter 0)."""
    h, w, _ = arr.shape
    raw = arr.astype(">u2").tobytes()
    stride = w * 6
    scan = b"".join(b"\0" + raw[y * stride:(y + 1) * stride]
                    for y in range(h))
    out = [b"\x89PNG\r\n\x1a\n",
           _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 0))]
    if icc:
        out.append(_png_chunk(
            b"iCCP", b"icc\0\0" + zlib.compress(icc)))
    out.append(_png_chunk(b"IDAT", zlib.compress(scan, 6)))
    out.append(_png_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(b"".join(out))


def read_png16(path: str) -> np.ndarray:
    """The (H, W, 3) uint16 pixels of a PNG as `_write_png16` writes it
    (16-bit RGB, not interlaced, filter 0 on every row); any other PNG
    raises ValueError."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, ihdr, idat = 8, None, []
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, payload = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", payload)
        elif tag == b"IDAT":
            idat.append(payload)
    if ihdr is None or (ihdr[2], ihdr[3], ihdr[6]) != (16, 2, 0):
        raise ValueError(f"{path}: not a 16-bit RGB PNG without interlace")
    w, h = ihdr[0], ihdr[1]
    scan = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8) \
        .reshape(h, 1 + 6 * w)
    if scan[:, 0].any():
        raise ValueError(f"{path}: filtered rows")
    return scan[:, 1:].copy().view(">u2").reshape(h, w, 3).astype(np.uint16)


def _write_tiff16(path: str, arr: np.ndarray, icc: Optional[bytes]) -> None:
    """(H, W, 3) uint16 -> minimal uncompressed little-endian TIFF."""
    h, w, _ = arr.shape
    pix = arr.astype("<u2").tobytes()
    entries = []
    extra = b""
    header_size = 8

    def entry(tag, typ, count, value, data=b""):
        entries.append((tag, typ, count, value, data))

    # layout: header(8) | IFD | extra data | pixels
    n_base = 11 + (1 if icc else 0)
    ifd_size = 2 + n_base * 12 + 4
    data_off = header_size + ifd_size

    def defer(data_bytes):
        nonlocal extra
        off = data_off + len(extra)
        extra += data_bytes
        return off

    bits_off = defer(struct.pack("<3H", 16, 16, 16))
    icc_off = defer(icc) if icc else 0
    pix_off = data_off + len(extra)

    entry(256, 4, 1, w)                    # ImageWidth
    entry(257, 4, 1, h)                    # ImageLength
    entry(258, 3, 3, bits_off)             # BitsPerSample
    entry(259, 3, 1, 1)                    # Compression: none
    entry(262, 3, 1, 2)                    # Photometric: RGB
    entry(273, 4, 1, pix_off)              # StripOffsets
    entry(277, 3, 1, 3)                    # SamplesPerPixel
    entry(278, 4, 1, h)                    # RowsPerStrip
    entry(279, 4, 1, len(pix))             # StripByteCounts
    entry(282, 3, 1, 72)                   # XResolution (int shortcut)
    entry(283, 3, 1, 72)                   # YResolution
    if icc:
        entry(34675, 7, len(icc), icc_off)  # InterColorProfile
    entries.sort()
    ifd = struct.pack("<H", len(entries))
    for tag, typ, count, value, _d in entries:
        ifd += struct.pack("<HHI", tag, typ, count)
        if typ == 3 and count == 1:
            ifd += struct.pack("<HH", value, 0)
        else:
            ifd += struct.pack("<I", value)
    ifd += struct.pack("<I", 0)
    with open(path, "wb") as f:
        f.write(b"II*\0" + struct.pack("<I", 8) + ifd + extra + pix)


def write_pfm(path: str, img_chw: np.ndarray) -> None:
    """Float PFM (format/pnm.c PFM branch)."""
    x = np.asarray(img_chw, np.float32).transpose(1, 2, 0)
    h, w, _ = x.shape
    with open(path, "wb") as f:
        f.write(f"PF\n{w} {h}\n-1.0\n".encode())
        f.write(x[::-1].astype("<f4").tobytes())


def write_exr(path: str, img_chw: np.ndarray) -> None:
    """Minimal OpenEXR 2.0 writer: half-float RGB, no compression,
    increasing-Y scanlines (format/exr.cc analog; linear scene data)."""
    import struct

    x = np.asarray(img_chw, np.float32)
    _, h, w = x.shape
    half = x.transpose(1, 2, 0).astype("<f2")  # (h, w, 3)

    def attr(name, typ, payload):
        return (name.encode() + b"\0" + typ.encode() + b"\0"
                + struct.pack("<i", len(payload)) + payload)

    # channel list: sorted alphabetically (B, G, R), pixel type 1 = HALF
    ch = b""
    for cname in (b"B", b"G", b"R"):
        ch += cname + b"\0" + struct.pack("<iiii", 1, 0, 1, 1)
    ch += b"\0"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = b""
    header += attr("channels", "chlist", ch)
    header += attr("compression", "compression", b"\0")  # NONE
    header += attr("dataWindow", "box2i", box)
    header += attr("displayWindow", "box2i", box)
    header += attr("lineOrder", "lineOrder", b"\0")  # increasing Y
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f",
                   struct.pack("<ff", 0.0, 0.0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"

    row_bytes = 2 * w  # per channel
    block = 8 + 3 * row_bytes  # [y, size] prefix + 3 channel rows
    data_off = 8 + len(header) + 8 * h
    with open(path, "wb") as f:
        f.write(struct.pack("<I", 20000630))        # magic
        f.write(struct.pack("<B3x", 2))             # version 2, flags 0
        f.write(header)
        for y in range(h):
            f.write(struct.pack("<Q", data_off + y * block))
        for y in range(h):
            f.write(struct.pack("<ii", y, 3 * row_bytes))
            # channels in alphabetical order: B, G, R planes per scanline
            f.write(half[y, :, 2].tobytes())
            f.write(half[y, :, 1].tobytes())
            f.write(half[y, :, 0].tobytes())


def write_image(path: str, img_chw: np.ndarray, quality: int = 92,
                bpp: int = 8, icc: Optional[bytes] = b"srgb",
                meta=None) -> None:
    """Write (3, H, W) float display RGB.  bpp: 8 or 16 (png/tiff only);
    icc: profile bytes, b"srgb" for the default, or None to omit.
    16-bit PNG/TIFF, PFM and EXR with icc=None need no PIL."""
    low = path.lower()
    if icc == b"srgb":
        icc = srgb_icc_bytes()
    exif = exif_from_meta(meta) if meta is not None else None

    if low.endswith(".pfm"):
        write_pfm(path, img_chw)
        return
    if low.endswith(".exr"):
        write_exr(path, img_chw)
        return
    if low.endswith(".pdf"):
        from .pdfwriter import write_pdf

        write_pdf(path, img_chw, bpp=bpp if bpp in (8, 16) else 8,
                  icc=icc or None)
        return
    if bpp == 16:
        arr16 = to_uint16(img_chw)
        if low.endswith(".png"):
            _write_png16(path, arr16, icc)
            return
        if low.endswith((".tif", ".tiff")):
            _write_tiff16(path, arr16, icc)
            return
        raise ValueError(f"16-bit output needs .png/.tif, got {path}")

    from PIL import Image

    arr = to_uint8(img_chw)
    im = Image.fromarray(arr)
    kw = {}
    if icc:
        kw["icc_profile"] = icc
    if exif:
        kw["exif"] = exif
    if low.endswith((".jpg", ".jpeg")):
        im.save(path, quality=quality, subsampling=0, **kw)
    elif low.endswith(".avif"):
        # AVIF format plugin (reference: src/imageio/format/avif.c —
        # libaom via libavif; here Pillow's bundled libavif encoder).
        # quality>=100 selects the reference's lossless mode
        # (avif.c AVIF_QUANTIZER_LOSSLESS path).
        if quality >= 100:
            im.save(path, quality=100, **kw)
        else:
            im.save(path, quality=quality, **kw)
    elif low.endswith((".jp2", ".j2k")):
        # JPEG-2000 format plugin (reference: src/imageio/format/j2k.c —
        # OpenJPEG; here Pillow's bundled OpenJPEG encoder).  quality>=100
        # = reversible 5/3 lossless (j2k.c's 100% quality path); below,
        # rate allocation approximating j2k.c's quality->rate mapping.
        if quality >= 100:
            im.save(path, irreversible=False, **kw)
        else:
            rate = max(1.0, 100.0 / max(1, 101 - quality))
            im.save(path, irreversible=True, quality_mode="rates",
                    quality_layers=[rate], **kw)
    elif low.endswith((".heif", ".heic")):
        # reference: src/imageio/format/heif.c (libheif/HEVC).  No HEVC
        # encoder exists in this environment; fail loudly rather than
        # silently writing a mislabeled container.
        raise ValueError(
            "HEIF output needs an HEVC encoder, which is unavailable; "
            "use .avif (same HEIF container family, AV1 codec) instead")
    else:
        im.save(path, **kw)
