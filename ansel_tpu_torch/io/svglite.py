"""svglite — minimal host-side SVG-subset rasterizer for watermarks.

The reference renders watermark SVGs with librsvg into a cairo surface
(`ansel/src/iop/watermark.c`, dt_render_svg) on the host; the pipe only
composites the resulting RGBA raster.  Copied from
`ansel_tpu/io/svglite.py`: rasterisation is a host-side job (ElementTree,
numpy and PIL's drawing, imported when a raster is rendered; <text> needs
the DejaVu fonts of `_FONTS`, the system's or, for the sans faces, the
package's copy in data/fonts/), and the device only sees the small RGBA
overlay.

Supported subset: <rect> <circle> <ellipse> <polygon> <polyline> <line>
<path> (M/L/H/V/C/S/Q/T/Z + relative; A flattened to a line) <text>/<tspan>,
<g> with translate/scale/rotate/matrix transforms, solid fills/strokes
(#hex, rgb(), named basics, style attr, fill-opacity/opacity); gradients
collapse to the mean of their stops (documented deviation — no gradient
ramps).  $(WATERMARK_TEXT)/$(WATERMARK_COLOR)/$(WATERMARK_FONT_*) variables
expand like watermark.c's substitution table.
"""

from __future__ import annotations

import math
import os
import re
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

_NAMED = {
    "black": (0, 0, 0), "white": (255, 255, 255), "red": (255, 0, 0),
    "green": (0, 128, 0), "blue": (0, 0, 255), "gray": (128, 128, 128),
    "grey": (128, 128, 128), "yellow": (255, 255, 0), "none": None,
}

_FONTS = {
    ("sans", False): "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
    ("sans", True): "/usr/share/fonts/truetype/dejavu/DejaVuSans-Bold.ttf",
    ("serif", False): "/usr/share/fonts/truetype/dejavu/DejaVuSerif.ttf",
}
# the two DejaVu Sans faces, copied into the package (data/fonts/, with
# their licence), for machines that have no system copy
_BUNDLED_FONTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "fonts")


def font_path(path: str) -> str:
    """A font of `_FONTS`: the system's file, else the package's copy of
    it, else the system path (which then fails to open)."""
    if os.path.exists(path):
        return path
    bundled = os.path.join(_BUNDLED_FONTS, os.path.basename(path))
    return bundled if os.path.exists(bundled) else path


def _parse_color(s: Optional[str]):
    if s is None:
        return None
    s = s.strip()
    if s.startswith("url("):
        return "gradient"
    if s.startswith("#"):
        h = s[1:]
        if len(h) == 3:
            h = "".join(c * 2 for c in h)
        try:
            return tuple(int(h[i:i + 2], 16) for i in (0, 2, 4))
        except ValueError:
            return None
    m = re.match(r"rgb\(\s*(\d+)[,\s]+(\d+)[,\s]+(\d+)", s)
    if m:
        return tuple(int(m.group(i)) for i in (1, 2, 3))
    return _NAMED.get(s.lower())


def _style_dict(el) -> Dict[str, str]:
    d = {}
    for k in ("fill", "stroke", "opacity", "fill-opacity", "stroke-width",
              "font-size", "font-family", "font-weight", "stroke-opacity"):
        if el.get(k) is not None:
            d[k] = el.get(k)
    for part in (el.get("style") or "").split(";"):
        if ":" in part:
            k, v = part.split(":", 1)
            d[k.strip()] = v.strip()
    return d


def _parse_transform(s: Optional[str]) -> np.ndarray:
    M = np.eye(3)
    if not s:
        return M
    for m in re.finditer(r"(\w+)\s*\(([^)]*)\)", s):
        op = m.group(1)
        args = [float(v) for v in re.split(r"[,\s]+", m.group(2).strip()) if v]
        T = np.eye(3)
        if op == "translate":
            T[0, 2] = args[0]
            T[1, 2] = args[1] if len(args) > 1 else 0.0
        elif op == "scale":
            T[0, 0] = args[0]
            T[1, 1] = args[1] if len(args) > 1 else args[0]
        elif op == "rotate":
            a = math.radians(args[0])
            cx, cy = (args[1], args[2]) if len(args) > 2 else (0.0, 0.0)
            R = np.array([[math.cos(a), -math.sin(a), 0],
                          [math.sin(a), math.cos(a), 0], [0, 0, 1]])
            C = np.eye(3)
            C[:2, 2] = (cx, cy)
            Ci = np.eye(3)
            Ci[:2, 2] = (-cx, -cy)
            T = C @ R @ Ci
        elif op == "matrix" and len(args) == 6:
            a, b, c, d, e, f = args
            T = np.array([[a, c, e], [b, d, f], [0, 0, 1]])
        M = M @ T
    return M


_PATH_RE = re.compile(r"([MmLlHhVvCcSsQqTtAaZz])|(-?\d*\.?\d+(?:[eE][-+]?\d+)?)")


def _flatten_path(d: str) -> List[List[Tuple[float, float]]]:
    """Path data -> list of polygons (flattened beziers, 12 segments)."""
    toks = [(t[0] or None, float(t[1]) if t[1] else None)
            for t in _PATH_RE.findall(d)]
    i = 0
    polys: List[List[Tuple[float, float]]] = []
    cur: List[Tuple[float, float]] = []
    x = y = sx = sy = 0.0
    px = py = None  # previous control point for S/T
    cmd = None

    def num():
        nonlocal i
        v = toks[i][1]
        i += 1
        return v

    def bez(p0, p1, p2, p3):
        for t in np.linspace(0, 1, 13)[1:]:
            mt = 1 - t
            cur.append((
                mt**3 * p0[0] + 3 * mt**2 * t * p1[0]
                + 3 * mt * t**2 * p2[0] + t**3 * p3[0],
                mt**3 * p0[1] + 3 * mt**2 * t * p1[1]
                + 3 * mt * t**2 * p2[1] + t**3 * p3[1]))

    while i < len(toks):
        if toks[i][0] is not None:
            cmd = toks[i][0]
            i += 1
            if cmd in "Zz":
                if cur:
                    polys.append(cur)
                cur = []
                x, y = sx, sy
                continue
        c = cmd or "L"
        rel = c.islower()
        C = c.upper()
        if C == "M":
            nx, ny = num(), num()
            if rel:
                nx, ny = x + nx, y + ny
            if cur:
                polys.append(cur)
            cur = [(nx, ny)]
            x, y, sx, sy = nx, ny, nx, ny
            cmd = "l" if rel else "L"
            px = py = None
        elif C == "L":
            nx, ny = num(), num()
            if rel:
                nx, ny = x + nx, y + ny
            cur.append((nx, ny))
            x, y = nx, ny
            px = py = None
        elif C == "H":
            nx = num()
            nx = x + nx if rel else nx
            cur.append((nx, y))
            x = nx
            px = py = None
        elif C == "V":
            ny = num()
            ny = y + ny if rel else ny
            cur.append((x, ny))
            y = ny
            px = py = None
        elif C in "CS":
            if C == "C":
                x1, y1 = num(), num()
                if rel:
                    x1, y1 = x + x1, y + y1
            else:
                x1, y1 = ((2 * x - px, 2 * y - py)
                          if px is not None else (x, y))
            x2, y2 = num(), num()
            x3, y3 = num(), num()
            if rel:
                x2, y2, x3, y3 = x + x2, y + y2, x + x3, y + y3
            bez((x, y), (x1, y1), (x2, y2), (x3, y3))
            px, py = x2, y2
            x, y = x3, y3
        elif C in "QT":
            if C == "Q":
                x1, y1 = num(), num()
                if rel:
                    x1, y1 = x + x1, y + y1
            else:
                x1, y1 = ((2 * x - px, 2 * y - py)
                          if px is not None else (x, y))
            x2, y2 = num(), num()
            if rel:
                x2, y2 = x + x2, y + y2
            # quadratic -> cubic
            bez((x, y), (x + 2 / 3 * (x1 - x), y + 2 / 3 * (y1 - y)),
                (x2 + 2 / 3 * (x1 - x2), y2 + 2 / 3 * (y1 - y2)), (x2, y2))
            px, py = x1, y1
            x, y = x2, y2
        elif C == "A":  # arc -> straight line (deviation)
            for _ in range(5):
                num()
            nx, ny = num(), num()
            if rel:
                nx, ny = x + nx, y + ny
            cur.append((nx, ny))
            x, y = nx, ny
            px = py = None
        else:
            i += 1
    if cur:
        polys.append(cur)
    return polys


def _tag(el) -> str:
    return el.tag.rsplit("}", 1)[-1]


def _gradient_mean(root, url: str):
    gid = re.match(r"url\(#(.+)\)", url or "")
    if not gid:
        return (128, 128, 128), 1.0
    colors, alphas = [], []
    for el in root.iter():
        if el.get("id") == gid.group(1):
            for stop in el.iter():
                if _tag(stop) == "stop":
                    sd = _style_dict(stop)
                    c = _parse_color(sd.get("stop-color")
                                     or stop.get("stop-color"))
                    a = float(sd.get("stop-opacity")
                              or stop.get("stop-opacity") or 1.0)
                    if c and c != "gradient":
                        colors.append(c)
                        alphas.append(a)
    if not colors:
        return (128, 128, 128), 1.0
    mean = tuple(int(np.mean([c[i] for c in colors])) for i in range(3))
    return mean, float(np.mean(alphas))


def render_svg(svg_text: str, out_w: int, out_h: int,
               variables: Dict[str, str] = None) -> np.ndarray:
    """Rasterize to an (out_h, out_w, 4) uint8 RGBA numpy array."""
    from PIL import Image, ImageDraw, ImageFont

    for k, v in (variables or {}).items():
        svg_text = svg_text.replace(f"$({k})", str(v))
    svg_text = re.sub(r"\$\([A-Z_.]+\)", "", svg_text)  # unknown vars -> ""
    root = ET.fromstring(svg_text)

    def flen(s, default=0.0):
        if s is None:
            return default
        m = re.match(r"-?\d*\.?\d+", s)
        return float(m.group(0)) if m else default

    doc_w = flen(root.get("width"), 100.0)
    doc_h = flen(root.get("height"), 100.0)
    vb = root.get("viewBox")
    off_x = off_y = 0.0
    if vb:
        vx, vy, vw, vh = [float(v) for v in re.split(r"[,\s]+", vb.strip())]
        off_x, off_y = -vx, -vy
        if doc_w == 100.0 and doc_h == 100.0:
            doc_w, doc_h = vw, vh
    ss = 2  # supersample
    W, H = max(out_w, 1) * ss, max(out_h, 1) * ss
    img = Image.new("RGBA", (W, H), (0, 0, 0, 0))
    draw = ImageDraw.Draw(img)
    base = np.array([[W / doc_w, 0, off_x * W / doc_w],
                     [0, H / doc_h, off_y * H / doc_h], [0, 0, 1]])

    def fill_of(el, inherited):
        sd = _style_dict(el)
        fill = sd.get("fill", inherited.get("fill", "#000000"))
        opacity = float(sd.get("opacity", 1.0)) * float(
            sd.get("fill-opacity", 1.0)) * inherited.get("_op", 1.0)
        return dict(inherited, fill=fill, _op=opacity, **{
            k: sd[k] for k in ("font-size", "font-family", "font-weight")
            if k in sd})

    def resolve_rgba(fill, op):
        c = _parse_color(fill) if fill != "gradient" else None
        if fill and fill.startswith("url("):
            c, ga = _gradient_mean(root, fill)
            op *= ga
        if c is None or c == "gradient":
            return None
        return (c[0], c[1], c[2], int(np.clip(op * 255, 0, 255)))

    def xf(M, pts):
        a = np.asarray([[p[0], p[1], 1.0] for p in pts]).T
        t = M @ a
        return [tuple(p) for p in t[:2].T]

    def walk(el, M, inh):
        t = _tag(el)
        if t in ("defs", "metadata", "style", "namedview"):
            return
        M2 = M @ _parse_transform(el.get("transform"))
        inh2 = fill_of(el, inh)
        rgba = resolve_rgba(inh2["fill"], inh2["_op"])
        if t == "g" or t == "svg":
            for ch in el:
                walk(ch, M2, inh2)
            return
        if rgba is None and t != "text":
            for ch in el:
                walk(ch, M2, inh2)
            return
        if t == "rect":
            x, y = flen(el.get("x")), flen(el.get("y"))
            w, h = flen(el.get("width")), flen(el.get("height"))
            draw.polygon(xf(M2, [(x, y), (x + w, y), (x + w, y + h),
                                 (x, y + h)]), fill=rgba)
        elif t in ("circle", "ellipse"):
            cx, cy = flen(el.get("cx")), flen(el.get("cy"))
            rx = flen(el.get("rx"), flen(el.get("r")))
            ry = flen(el.get("ry"), flen(el.get("r")))
            pts = [(cx + rx * math.cos(a), cy + ry * math.sin(a))
                   for a in np.linspace(0, 2 * math.pi, 48)]
            draw.polygon(xf(M2, pts), fill=rgba)
        elif t in ("polygon", "polyline"):
            nums = [float(v) for v in
                    re.split(r"[,\s]+", (el.get("points") or "").strip()) if v]
            pts = list(zip(nums[::2], nums[1::2]))
            if len(pts) >= 3:
                draw.polygon(xf(M2, pts), fill=rgba)
        elif t == "path":
            for poly in _flatten_path(el.get("d") or ""):
                if len(poly) >= 3:
                    draw.polygon(xf(M2, poly), fill=rgba)
        elif t == "text":
            texts = [(el.get("x"), el.get("y"), (el.text or "").strip(), el)]
            for ts in el:
                if _tag(ts) == "tspan":
                    texts.append((ts.get("x", el.get("x")),
                                  ts.get("y", el.get("y")),
                                  (ts.text or "").strip(), ts))
            for txs, tys, txt, src in texts:
                if not txt:
                    continue
                sub = fill_of(src, inh2)
                rgba_t = resolve_rgba(sub["fill"], sub["_op"]) or rgba
                size = flen(sub.get("font-size", "16"), 16.0)
                fam = "serif" if "serif" in sub.get(
                    "font-family", "sans").lower() else "sans"
                bold = "bold" in sub.get("font-weight", "").lower()
                fpath = font_path(_FONTS.get((fam, bold),
                                             _FONTS[("sans", False)]))
                sc = float(np.hypot(M2[0, 0], M2[1, 0]))
                font = ImageFont.truetype(fpath,
                                          max(int(size * sc), 4))
                ox, oy = xf(M2, [(flen(txs), flen(tys))])[0]
                draw.text((ox, oy - font.size), txt, fill=rgba_t, font=font)

    walk(root, base, {"fill": "#000000", "_op": 1.0})
    img = img.resize((max(out_w, 1), max(out_h, 1)), Image.LANCZOS)
    return np.asarray(img, np.uint8)
