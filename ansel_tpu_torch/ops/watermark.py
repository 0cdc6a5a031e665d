"""watermark — SVG/text overlay composited on the export.

Reference: `ansel/src/iop/watermark.c` (params v5 :62-87; layout math
in process(): user scale :150-187, aspect-fit svg size :190-220, rotation
bounding box :270-274, 3x3 alignment grid + x/y offsets :276-300, cairo
source-over composite :320-360).  librsvg+cairo render on the host; only
the composite runs in the pipe.  Copied from `ansel_tpu/ops/watermark.py`:
`io/svglite.py` rasterises on the host while planning (the overlay and
its hash are part of the plan), and the device does one source-over
blend of the small RGBA overlay into a copy of the frame, in plain torch.
The DejaVu Sans faces come from the system, else from the package's copy
(`data/fonts/`), so the glyphs are the same file's on either machine.

Asset resolution: SVG files are searched in `$ANSEL_TPU_WATERMARK_DIR`,
then `ansel_tpu_torch/data/watermarks/`.  A non-empty `text` param
renders the simple-text watermark directly (PIL, the DejaVu fonts),
imported while planning; where PIL or a font the overlay needs is
missing, planning refuses with `not_ported`, naming what is missing.  A
missing SVG is a loud no-op: the pipeline records it in
ctx.notes["watermark_missing"].

The plan's static holds Python's `hash` of the overlay's bytes, which
changes between processes: compare plans within one process only.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np

from ..core.params import cfield, params
from .base import Op, OpPlan, PlanContext, not_ported, register

SCALE_IMAGE, SCALE_LARGER, SCALE_SMALLER = 0, 1, 2


@params(op="watermark", version=5)
@dataclasses.dataclass
class WatermarkParams:
    opacity: float = cfield("f", 100.0)
    scale: float = cfield("f", 100.0)
    xoffset: float = cfield("f", 0.0)
    yoffset: float = cfield("f", 0.0)
    alignment: int = cfield("i", 4)
    rotate: float = cfield("f", 0.0)
    sizeto: int = cfield("i", SCALE_IMAGE)
    filename: str = cfield("s:64", "darktable.svg")
    text: str = cfield("s:512", "")
    color: tuple = cfield("3f", (0.0, 0.0, 0.0))
    font: str = cfield("s:64", "DejaVu Sans 10")


    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        def cut(b):
            return b.split(b"\x00")[0].decode("utf-8", "replace")

        # watermark.c ladder (:139-260)
        if version == 1:  # {opacity, scale, xoff, yoff, align, file[64]}
            v = struct.unpack("<4fi64s", raw[:84])
            return cls(opacity=v[0], scale=v[1], xoffset=v[2],
                       yoffset=v[3], alignment=v[4], rotate=0.0,
                       sizeto=0, filename=cut(v[5]), text="",
                       color=(0.0, 0.0, 0.0), font="DejaVu Sans 10")
        if version == 2:  # + sizeto
            v = struct.unpack("<4f2i64s", raw[:88])
            return cls(opacity=v[0], scale=v[1], xoffset=v[2],
                       yoffset=v[3], alignment=v[4], rotate=0.0,
                       sizeto=v[5], filename=cut(v[6]), text="",
                       color=(0.0, 0.0, 0.0), font="DejaVu Sans 10")
        if version == 3:  # + rotate
            v = struct.unpack("<4fifi64s", raw[:92])
            return cls(opacity=v[0], scale=v[1], xoffset=v[2],
                       yoffset=v[3], alignment=v[4], rotate=v[5],
                       sizeto=v[6], filename=cut(v[7]), text="",
                       color=(0.0, 0.0, 0.0), font="DejaVu Sans 10")
        if version == 4:  # + text[64]/color[3]/font[64]
            v = struct.unpack("<4fifi64s64s3f64s", raw[:232])
            return cls(opacity=v[0], scale=v[1], xoffset=v[2],
                       yoffset=v[3], alignment=v[4], rotate=v[5],
                       sizeto=v[6], filename=cut(v[7]), text=cut(v[8]),
                       color=tuple(v[9:12]), font=cut(v[12]))
        return None


def _find_svg(name: str):
    for d in (os.environ.get("ANSEL_TPU_WATERMARK_DIR"),
              os.path.join(os.path.dirname(os.path.dirname(__file__)),
                           "data", "watermarks")):
        if d and name:
            p = os.path.join(d, name)
            if os.path.exists(p):
                return p
    return None


def _text_font(font_desc: str) -> str:
    from ..io.svglite import font_path

    bold = "bold" in font_desc.lower()
    return font_path("/usr/share/fonts/truetype/dejavu/DejaVuSans-Bold.ttf"
                     if bold else
                     "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf")


def _missing(p: WatermarkParams):
    """What rendering p's overlay needs and the running machine lacks
    (PIL, or the font of the text mode), else None.  A font an SVG's
    <text> names shows only while rendering (`Watermark.plan` catches
    it)."""
    try:
        import PIL.Image  # noqa: F401
    except ImportError:
        return "PIL"
    if p.text and not os.path.exists(_text_font(p.font)):
        return f"the font {_text_font(p.font)}"
    return None


def _render_text(text: str, color, font_desc: str, height_px: int):
    """Simple-text mode (watermark.c simple text branch + simple-text.svg)."""
    from PIL import Image, ImageDraw, ImageFont

    path = _text_font(font_desc)
    size = max(int(height_px), 8)
    font = ImageFont.truetype(path, size)
    bbox = font.getbbox(text)
    w = max(bbox[2] - bbox[0], 1)
    h = max(bbox[3] - bbox[1], 1)
    img = Image.new("RGBA", (w + 4, h + 4), (0, 0, 0, 0))
    rgb = tuple(int(np.clip(c * 255, 0, 255)) for c in color)
    ImageDraw.Draw(img).text((2 - bbox[0], 2 - bbox[1]), text,
                             fill=rgb + (255,), font=font)
    return np.asarray(img, np.uint8)


def _build_overlay(p: WatermarkParams, iw: int, ih: int):
    """-> (rgba float32 (4, oh, ow) premultiplied by opacity, x0, y0)."""
    uscale = p.scale / 100.0
    if p.text:
        raster = _render_text(p.text, p.color, p.font, ih * 0.05 * uscale)
        dim_w, dim_h = raster.shape[1], raster.shape[0]
        svg_w, svg_h = float(dim_w), float(dim_h)
        raster_full = raster
    else:
        path = _find_svg(p.filename)
        if path is None:
            return None
        from ..io.svglite import render_svg

        svg_text = open(path, encoding="utf-8").read()
        # probe intrinsic dimensions
        import re as _re

        mw = _re.search(r'width="(-?[\d.]+)', svg_text)
        mh = _re.search(r'height="(-?[\d.]+)', svg_text)
        dim_w = float(mw.group(1)) if mw else 100.0
        dim_h = float(mh.group(1)) if mh else 100.0
        # aspect-fit sizing (watermark.c:190-220)
        if p.sizeto == SCALE_IMAGE:
            if dim_w / dim_h > iw / ih:
                svg_w = iw * uscale
                svg_h = dim_h * (svg_w / dim_w)
            else:
                svg_h = ih * uscale
                svg_w = dim_w * (svg_h / dim_h)
        else:
            larger = max(dim_w, dim_h)
            base = (max(iw, ih) if p.sizeto == SCALE_LARGER
                    else min(iw, ih))
            svg_w = dim_w * base * uscale / larger
            svg_h = dim_h * base * uscale / larger
        raster_full = render_svg(svg_text, max(int(round(svg_w)), 1),
                                 max(int(round(svg_h)), 1))
    if p.text:
        # text raster is already at natural size; scale to requested height
        svg_h = ih * 0.05 * uscale
        svg_w = svg_h * dim_w / dim_h
        from PIL import Image

        raster_full = np.asarray(Image.fromarray(raster_full).resize(
            (max(int(svg_w), 1), max(int(svg_h), 1)), Image.LANCZOS))
    svg_w, svg_h = raster_full.shape[1], raster_full.shape[0]

    # rotate about the center (watermark.c:270-274,302-308)
    if abs(p.rotate) > 1e-3:
        from PIL import Image

        img = Image.fromarray(raster_full).rotate(
            p.rotate, expand=True, resample=Image.BICUBIC)
        raster_full = np.asarray(img)
    bb_h, bb_w = raster_full.shape[:2]
    bX = bb_w / 2.0 - svg_w / 2.0
    bY = bb_h / 2.0 - svg_h / 2.0

    # 3x3 alignment (watermark.c:276-292)
    if p.alignment < 3:
        ty = bY
    elif p.alignment < 6:
        ty = ih / 2.0 - svg_h / 2.0
    else:
        ty = ih - svg_h - bY
    col = p.alignment % 3
    if col == 0:
        tx = bX
    elif col == 1:
        tx = iw / 2.0 - svg_w / 2.0
    else:
        tx = iw - svg_w - bX
    tx += p.xoffset * iw
    ty += p.yoffset * ih
    x0 = int(round(tx - bX))
    y0 = int(round(ty - bY))

    rgba = np.asarray(raster_full, np.float32) / 255.0
    # crop overlay to the frame
    cx0, cy0 = max(-x0, 0), max(-y0, 0)
    cx1 = min(bb_w, iw - x0)
    cy1 = min(bb_h, ih - y0)
    if cx1 <= cx0 or cy1 <= cy0:
        return None
    rgba = rgba[cy0:cy1, cx0:cx1]
    rgba[..., 3] *= np.clip(p.opacity / 100.0, 0.0, 1.0)
    return rgba.transpose(2, 0, 1).copy(), x0 + cx0, y0 + cy0


@register
class Watermark(Op):
    name = "watermark"
    input_colorspace = None  # display-referred RGB (late in the pipe)

    def enabled_by_default(self, meta):
        return False

    def plan(self, ctx: PlanContext, spec_in, p: WatermarkParams) -> OpPlan:
        mode = "the text mode" if p.text else "the SVG mode"
        missing = _missing(p)
        if missing is not None:
            raise not_ported(self.name, f"{mode} without {missing}")
        try:
            built = _build_overlay(p, spec_in.width, spec_in.height)
        except OSError as e:  # a font an SVG's <text> names
            raise not_ported(self.name, f"{mode} without a font it "
                             f"needs ({e})") from e
        if built is None:
            missing = ctx.notes.setdefault("watermark_missing", [])
            if p.filename not in missing:
                missing.append(p.filename)
            return OpPlan(spec_in=spec_in, spec_out=spec_in, static=None)
        rgba, x0, y0 = built
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(rgba.shape, x0, y0,
                              hash(rgba.tobytes())), aux=rgba)

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p):
        if plan.static is None:
            return None
        return {"rgba": plan.aux}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        if plan.static is None:
            return x
        (_, oh, ow), x0, y0, _h = plan.static
        rgba = c["rgba"]
        sub = x[:, y0:y0 + oh, x0:x0 + ow]
        a = rgba[3:4]
        out = x.clone()
        out[:, y0:y0 + oh, x0:x0 + ow] = sub * (1.0 - a) + rgba[:3] * a
        return out
