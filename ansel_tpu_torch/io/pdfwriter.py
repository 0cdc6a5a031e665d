"""PDF export format — single/multi-page PDFs with embedded images
(copied from `ansel_tpu/io/pdfwriter.py`; numpy and zlib only).

Mirrors the reference's PDF plugin pair:
`ansel/src/common/pdf.c` (the minimal PDF object writer:
dt_pdf_start/add_icc/add_image/add_page/finish, stream encoders
UNCOMPRESSED/FLATE) and `ansel/src/imageio/format/pdf.c`
(paper-size/border params, 8/16 bpp, ICC embedding, rotate-to-fit,
NORMAL/DRAFT/DEBUG modes).

Design differences from the C writer: objects are accumulated in memory
and the xref table is emitted once at the end (the reference streams to
disk and tracks offsets as it goes) — same file format, simpler host
code.  Images are raw RGB streams (FlateDecode by default), exactly like
the reference's DT_PDF_STREAM_ENCODER_FLATE path; 16-bit samples are
big-endian per the PDF spec.
"""

from __future__ import annotations

import time
import zlib
from typing import List, Optional, Tuple

import numpy as np

# --- lengths & paper sizes (common/pdf.c:69-160) ----------------------------

_POINT_PER_INCH = 72.0


def _mm_to_point(mm: float) -> float:
    return mm / 25.4 * _POINT_PER_INCH


# dt_pdf_units (common/pdf.h:92-99)
_UNITS = {
    "mm": _mm_to_point(1.0),
    "cm": _mm_to_point(10.0),
    "inch": _POINT_PER_INCH,
    '"': _POINT_PER_INCH,
    "pt": 1.0,  # bare points accepted too (unit-less default)
}

# dt_pdf_paper_sizes (common/pdf.h:108-115)
PAPER_SIZES = {
    "a4": (_mm_to_point(210), _mm_to_point(297)),
    "a3": (_mm_to_point(297), _mm_to_point(420)),
    "letter": (8.5 * _POINT_PER_INCH, 11.0 * _POINT_PER_INCH),
    "legal": (8.5 * _POINT_PER_INCH, 14.0 * _POINT_PER_INCH),
}


def parse_length(s: str) -> Optional[float]:
    """'10 mm' / '1 cm' / '0.5 inch' / '12' -> points
    (dt_pdf_parse_length, common/pdf.c:69-98)."""
    s = s.strip().replace(",", ".")
    if not s:
        return None
    num = ""
    i = 0
    while i < len(s) and (s[i].isdigit() or s[i] in ".-+"):
        num += s[i]
        i += 1
    try:
        v = float(num)
    except ValueError:
        return None
    unit = s[i:].strip().lower()
    if not unit:
        return v  # == 0.0 or bare points
    if unit not in _UNITS:
        return None
    return v * _UNITS[unit]


def parse_paper_size(s: str) -> Optional[Tuple[float, float]]:
    """'a4' / 'letter' / '210 mm x 297 mm' / '8.5 x 11 inch' -> (w, h) pt
    (dt_pdf_parse_paper_size, common/pdf.c:117-160)."""
    key = s.strip().lower()
    if key in PAPER_SIZES:
        return PAPER_SIZES[key]
    norm = key.replace("*", "x")
    if "x" not in norm:
        return None
    a, b = norm.split("x", 1)
    a, b = a.strip(), b.strip()
    wa = parse_length(a)
    hb = parse_length(b)
    if hb is None:
        return None
    if wa is None or not any(ch.isalpha() or ch == '"' for ch in a):
        # width had no unit of its own -> inherit height's unit
        try:
            wnum = float(a.replace(",", "."))
        except ValueError:
            return None
        unit = "".join(c for c in b if c.isalpha() or c == '"').strip()
        wa = wnum * _UNITS.get(unit, 1.0)
    return (wa, hb)


# --- the PDF object writer (common/pdf.c dt_pdf_t) ---------------------------

MODE_NORMAL, MODE_DRAFT, MODE_DEBUG = 0, 1, 2


class PdfWriter:
    """Accumulates numbered PDF objects; `finish()` writes body + xref."""

    def __init__(self, page_width: float, page_height: float,
                 dpi: float = 300.0, compress: bool = True,
                 title: Optional[str] = None):
        self.page_width = float(page_width)
        self.page_height = float(page_height)
        self.dpi = float(dpi)
        self.compress = compress
        self.title = title
        self._objs: List[bytes] = []  # index i -> object number i+1
        self._images: List[dict] = []
        self._pages: List[int] = []  # page object numbers

    def _add_obj(self, body: bytes) -> int:
        self._objs.append(body)
        return len(self._objs)

    def add_icc(self, icc_bytes: bytes) -> int:
        """Embed an ICC profile as an ICCBased colorspace; returns the
        colorspace object number (dt_pdf_add_icc_from_data)."""
        data = zlib.compress(icc_bytes) if self.compress else icc_bytes
        filt = b"/Filter /FlateDecode " if self.compress else b""
        stream_no = self._add_obj(
            b"<< /N 3 " + filt
            + b"/Length %d >>\nstream\n" % len(data) + data
            + b"\nendstream")
        return self._add_obj(b"[ /ICCBased %d 0 R ]" % stream_no)

    def add_image(self, img_chw: np.ndarray, bpp: int = 8,
                  icc_obj: int = 0, border_pt: float = 0.0,
                  rotate_to_fit: bool = False) -> int:
        """Add one image => one page slot (dt_pdf_add_image).  border is
        empty space inside the page on all four sides."""
        assert bpp in (8, 16)
        x = np.clip(np.asarray(img_chw, np.float32), 0.0, 1.0)
        c, h, w = x.shape
        assert c == 3
        scale = (1 << bpp) - 1
        q = np.rint(x * scale).astype(np.uint8 if bpp == 8 else ">u2")
        raw = q.transpose(1, 2, 0).tobytes()  # interleaved RGB rows
        data = zlib.compress(raw) if self.compress else raw
        filt = b"/Filter /FlateDecode " if self.compress else b""
        cs = (b"%d 0 R" % icc_obj) if icc_obj else b"/DeviceRGB"
        obj_no = self._add_obj(
            b"<< /Type /XObject /Subtype /Image /Width %d /Height %d "
            b"/ColorSpace %s /BitsPerComponent %d %s/Length %d >>\n"
            b"stream\n" % (w, h, cs, bpp, filt, len(data))
            + data + b"\nendstream")
        idx = len(self._images)
        self._images.append(dict(obj=obj_no, w=w, h=h, border=border_pt,
                                 rotate=rotate_to_fit))
        return idx

    # layout (common/pdf.c dt_pdf_add_page): fit the image into the
    # printable box keeping aspect, centered; optionally rotate 90° when
    # the rotated orientation fits larger.
    def _place(self, im: dict) -> Tuple[float, float, float, float, bool]:
        bw = self.page_width - 2.0 * im["border"]
        bh = self.page_height - 2.0 * im["border"]
        iw, ih = float(im["w"]), float(im["h"])
        s_norm = min(bw / iw, bh / ih)
        s_rot = min(bw / ih, bh / iw)
        rotate = im["rotate"] and s_rot > s_norm
        s = s_rot if rotate else s_norm
        dw, dh = (ih * s, iw * s) if rotate else (iw * s, ih * s)
        x0 = im["border"] + (bw - dw) / 2.0
        y0 = im["border"] + (bh - dh) / 2.0
        return x0, y0, dw, dh, rotate

    def add_page(self, image_idx: int, mode: int = MODE_NORMAL) -> None:
        im = self._images[image_idx]
        x0, y0, dw, dh, rotate = self._place(im)
        ops = [b"q"]
        if mode == MODE_NORMAL:
            if rotate:
                # translate to box origin, rotate 90° CW about the placed
                # box: CTM = [0 -1; 1 0] with offset
                ops.append(b"%f %f %f %f %f %f cm"
                           % (0.0, -1.0, 1.0, 0.0, x0, y0 + dh))
                ops.append(b"%f 0 0 %f 0 0 cm" % (dh, dw))
            else:
                ops.append(b"%f 0 0 %f %f %f cm" % (dw, dh, x0, y0))
            ops.append(b"/Im%d Do" % image_idx)
        else:  # DRAFT/DEBUG: outline box instead of pixels (pdf.c:309-316)
            ops.append(b"0.7 0.7 0.7 RG 1 w")
            ops.append(b"%f %f %f %f re S" % (x0, y0, dw, dh))
        if mode == MODE_DEBUG:
            ops.append(b"1 0 0 RG 0.5 w")
            ops.append(b"%f %f %f %f re S"
                       % (im["border"], im["border"],
                          self.page_width - 2 * im["border"],
                          self.page_height - 2 * im["border"]))
        ops.append(b"Q")
        content = b"\n".join(ops)
        cdata = zlib.compress(content) if self.compress else content
        filt = b"/Filter /FlateDecode " if self.compress else b""
        content_no = self._add_obj(
            b"<< %s/Length %d >>\nstream\n" % (filt, len(cdata))
            + cdata + b"\nendstream")
        # page object (parent patched in finish)
        self._pages.append(self._add_obj(
            b"<< /Type /Page /Parent PARENT 0 R "
            b"/MediaBox [0 0 %f %f] "
            b"/Resources << /XObject << /Im%d %d 0 R >> >> "
            b"/Contents %d 0 R >>"
            % (self.page_width, self.page_height,
               image_idx, im["obj"], content_no)))

    def finish(self, path: str) -> None:
        pages_no = self._add_obj(
            b"<< /Type /Pages /Kids [ "
            + b" ".join(b"%d 0 R" % p for p in self._pages)
            + b" ] /Count %d >>" % len(self._pages))
        catalog_no = self._add_obj(
            b"<< /Type /Catalog /Pages %d 0 R >>" % pages_no)
        info = b"<< /Producer (ansel_tpu) "
        if self.title:
            safe = self.title.replace("\\", r"\\").replace("(", r"\(") \
                .replace(")", r"\)")
            info += b"/Title (%s) " % safe.encode("latin-1", "replace")
        info += b"/CreationDate (D:%s) >>" % time.strftime(
            "%Y%m%d%H%M%S").encode()
        info_no = self._add_obj(info)

        out = bytearray(b"%PDF-1.4\n%\xe2\xe3\xcf\xd3\n")
        offsets = []
        for i, body in enumerate(self._objs):
            body = body.replace(b"PARENT", b"%d" % pages_no)
            offsets.append(len(out))
            out += b"%d 0 obj\n" % (i + 1) + body + b"\nendobj\n"
        xref_off = len(out)
        n = len(self._objs) + 1
        out += b"xref\n0 %d\n" % n
        out += b"0000000000 65535 f \n"
        for off in offsets:
            out += b"%010d 00000 n \n" % off
        out += (b"trailer\n<< /Size %d /Root %d 0 R /Info %d 0 R >>\n"
                b"startxref\n%d\n%%%%EOF\n"
                % (n, catalog_no, info_no, xref_off))
        with open(path, "wb") as f:
            f.write(bytes(out))


def write_pdf(path: str, img_chw: np.ndarray, *, size: str = "a4",
              border: str = "0 mm", dpi: float = 300.0, bpp: int = 8,
              rotate: bool = True, compress: bool = True,
              icc: Optional[bytes] = None, title: Optional[str] = None,
              mode: int = MODE_NORMAL) -> None:
    """One image -> one-page PDF (format/pdf.c write_image path)."""
    ps = parse_paper_size(size)
    if ps is None:
        raise ValueError(f"invalid paper size: {size!r}")
    b = parse_length(border)
    if b is None:
        b = 0.0
    pdf = PdfWriter(ps[0], ps[1], dpi=dpi, compress=compress, title=title)
    icc_obj = pdf.add_icc(icc) if (icc and mode == MODE_NORMAL) else 0
    idx = pdf.add_image(img_chw, bpp=bpp, icc_obj=icc_obj, border_pt=b,
                        rotate_to_fit=rotate)
    pdf.add_page(idx, mode=mode)
    pdf.finish(path)
