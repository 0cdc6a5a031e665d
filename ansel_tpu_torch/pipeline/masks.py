"""Drawn (vector) masks: circle, ellipse, gradient, polygon, brush and
group forms, rasterised in torch (`ansel_tpu/pipeline/masks.py`).

Reference: `src/develop/masks.h` (node structs :234-291, type enum
:134-145, states :171-181, DEVELOP_MASKS_VERSION 6) and
`src/develop/masks/{circle,ellipse,gradient,polygon,brush,group}.c`: the
circle's quadratic falloff between radius and radius + border, the
ellipse's projected falloff, the gradient's 0.5 + 0.5 erf, the group's
union (max), intersection (min), difference (b1 (1 - b2)) and exclusion.

A sidecar's `darktable:masks_history` carries each form as a type, an id
and a packed array of node structs; `Form` holds one and `decode_points`
unpacks its nodes (the XMP reader fills `XMPDocument.masks`).  Shapes
evaluate over a grid of pixel positions; the shape's scalars are float32
host values, as the JAX package's are float32 trace-time constants.
Polygon and brush outlines are sampled on the host into polylines
(`_bezier_polyline`) and evaluated edge by edge (`_scan_edges`: the JAX
package's `lax.scan` over edges as a loop).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional

import numpy as np
import torch

from ..color.transforms import fdiv

# dt_masks_type_t (masks.h:134-145)
MASK_CIRCLE = 1 << 0
MASK_POLYGON = 1 << 1
MASK_GROUP = 1 << 2
MASK_CLONE = 1 << 3
MASK_GRADIENT = 1 << 4
MASK_ELLIPSE = 1 << 5
MASK_BRUSH = 1 << 6

# dt_masks_points_states_t (masks.h:171-181)
STATE_INVERSE = 1 << 2
STATE_UNION = 1 << 3
STATE_INTERSECTION = 1 << 4
STATE_DIFFERENCE = 1 << 5
STATE_EXCLUSION = 1 << 6

ELLIPSE_PROPORTIONAL = 1  # dt_masks_ellipse_flags_t
GRADIENT_LINEAR = 0

MASKS_VERSION = 6


@dataclasses.dataclass
class Form:
    """One mask form (dt_masks_form_t analog)."""

    id: int
    type: int
    name: str = ""
    version: int = MASKS_VERSION
    nodes: List[tuple] = dataclasses.field(default_factory=list)
    # clone-source position in normalized coords (dt_masks_form_t.source,
    # serialized as the XMP mask_src blob)
    src: tuple = (0.0, 0.0)

    def points_blob(self) -> bytes:
        fmt, _ = _NODE_CODECS[_base_type(self.type)]
        return b"".join(struct.pack(fmt, *n) for n in self.nodes)

    def src_blob(self) -> bytes:
        return struct.pack("<2f", *self.src)


# struct formats per node type (masks.h:234-291)
_NODE_CODECS = {
    MASK_CIRCLE: ("<4f", 4),            # cx, cy, radius, border
    MASK_ELLIPSE: ("<6fi", 7),          # cx, cy, rx, ry, rotation, border, flags
    MASK_POLYGON: ("<8fi", 9),          # node2 ctrl1_2 ctrl2_2 border2 state
    MASK_BRUSH: ("<10fi", 11),          # ... + density, hardness, state
    MASK_GRADIENT: ("<6fi", 7),         # cx, cy, rotation, extent, steepness,
                                        # curvature, state
    MASK_GROUP: ("<3if", 4),            # formid, parentid, state, opacity
}


def _base_type(t: int) -> int:
    return t & (MASK_CIRCLE | MASK_POLYGON | MASK_GROUP | MASK_GRADIENT
                | MASK_ELLIPSE | MASK_BRUSH)


def decode_points(mask_type: int, blob: bytes, nb: int) -> List[tuple]:
    fmt, _n = _NODE_CODECS[_base_type(mask_type)]
    size = struct.calcsize(fmt)
    out = []
    for i in range(nb):
        chunk = blob[i * size:(i + 1) * size]
        if len(chunk) < size:
            break
        out.append(struct.unpack(fmt, chunk))
    return out


# --- rasterisers -------------------------------------------------------------

F32 = np.float32


def _grid(H: int, W: int, origin=(0, 0), device="cpu"):
    """(x, y): each pixel's float32 column and row in the image."""
    y = torch.arange(H, dtype=torch.float32, device=device)[:, None] \
        + float(origin[0])
    x = torch.arange(W, dtype=torch.float32, device=device)[None, :] \
        + float(origin[1])
    return x.expand(H, W), y.expand(H, W)


def _sq(v):
    return v * v


def _circle_mask(node, H, W, nh, nw, origin=(0, 0), device="cpu"):
    cx, cy, radius, border = (F32(v) for v in node[:4])
    x, y = _grid(H, W, origin, device)
    mind = F32(min(nw, nh))
    l2 = _sq(x - float(cx * F32(nw))) + _sq(y - float(cy * F32(nh)))
    r2 = _sq(radius * mind)
    t2 = _sq((radius + border) * mind)
    f = torch.clamp(fdiv(float(t2) - l2, float(max(t2 - r2, F32(1e-9)))),
                    0.0, 1.0)
    return f * f


def _ellipse_mask(node, H, W, nh, nw, origin=(0, 0), device="cpu"):
    cx, cy, r0, r1, rotation, border = (F32(v) for v in node[:6])
    flags = int(node[6])
    x, y = _grid(H, W, origin, device)
    mind = F32(min(nw, nh))
    xr = x - float(cx * F32(nw))
    yr = y - float(cy * F32(nh))
    one = F32(1.0)
    if flags & ELLIPSE_PROPORTIONAL:
        t0, t1 = r0 * (one + border), r1 * (one + border)
    else:
        t0, t1 = r0 + border, r1 + border
    # axis ordering and rotation convention (ellipse.c:_ellipse_get_mask)
    swap = r0 < r1
    a = (r1 if swap else r0) * mind
    b = (r0 if swap else r1) * mind
    ta = (t1 if swap else t0) * mind
    tb = (t0 if swap else t1) * mind
    alpha = (rotation - F32(90.0) if swap else rotation) * F32(np.pi / 180.0)
    l2 = xr * xr + yr * yr
    l = torch.sqrt(l2)
    inv = torch.where(l > 0, fdiv(1.0, torch.clamp(l, min=1e-20)), 0.0)
    xn = xr * inv
    yn = torch.where(l > 0, yr * inv, 1.0)
    ca, sa = float(np.cos(alpha)), float(np.sin(alpha))
    xrot = xn * ca + yn * sa
    yrot = -xn * sa + yn * ca
    cosv2, sinv2 = xrot * xrot, yrot * yrot
    radius2 = fdiv(float(a * a * b * b),
                   float(a * a) * sinv2 + float(b * b) * cosv2)
    total2 = fdiv(float(ta * ta * tb * tb),
                  float(ta * ta) * sinv2 + float(tb * tb) * cosv2)
    f = torch.clamp((total2 - l2) / torch.clamp(total2 - radius2, min=1e-9),
                    0.0, 1.0)
    return f * f


def _gradient_mask(node, H, W, nh, nw, origin=(0, 0), device="cpu"):
    cx, cy, rotation, extent, _steep, curvature = (F32(v) for v in node[:6])
    state = int(node[6])
    x, y = _grid(H, W, origin, device)
    hwscale = 1.0 / float(np.hypot(nw, nh))
    v = -rotation / F32(180.0) * F32(np.pi)
    sinv, cosv = np.sin(v), np.cos(v)
    xoff = cosv * cx * F32(nw) + sinv * cy * F32(nh)
    yoff = sinv * cx * F32(nw) - cosv * cy * F32(nh)
    ext = float(max(extent, F32(0.001)))
    x0 = (float(cosv) * x + float(sinv) * y - float(xoff)) * hwscale
    y0 = (float(sinv) * x - float(cosv) * y - float(yoff)) * hwscale
    distance = y0 - float(curvature) * x0 * x0
    if state == GRADIENT_LINEAR:
        val = 0.5 + fdiv(0.5 * distance, ext)
    else:
        val = 0.5 + 0.5 * torch.erf(fdiv(distance, ext))
    return torch.clamp(val, 0.0, 1.0)


def _bezier_polyline(nodes, nh, nw, samples_per_seg: int = 20):
    """Host side: the closed cubic-bezier outline (and the border widths)
    sampled into numpy arrays, normalised coordinates -> pixels."""
    pts = []
    borders = []
    n = len(nodes)
    for i in range(n):
        p0 = np.array(nodes[i][0:2])
        c1 = np.array(nodes[i][4:6])          # ctrl2 of current
        nxt = nodes[(i + 1) % n]
        c2 = np.array(nxt[2:4])               # ctrl1 of next
        p1 = np.array(nxt[0:2])
        # border[0]/border[1] are normalised border radii (after/before
        # the node), scaled by MIN(iwd, iht) (polygon.c:801-810,
        # brush.c:838-847)
        b0 = float(nodes[i][7])
        b1 = float(nxt[6])
        t = np.linspace(0.0, 1.0, samples_per_seg, endpoint=False)[:, None]
        seg = ((1 - t) ** 3 * p0 + 3 * (1 - t) ** 2 * t * c1
               + 3 * (1 - t) * t ** 2 * c2 + t ** 3 * p1)
        pts.append(seg)
        borders.append((1 - t[:, 0]) * b0 + t[:, 0] * b1)
    P = np.concatenate(pts)           # (N, 2) normalised
    B = np.concatenate(borders)       # (N,) normalised border width
    P = P * np.array([nw, nh])
    B = B * min(nw, nh)
    return P.astype(np.float32), np.maximum(B, 1e-3).astype(np.float32)


def _scan_edges(P, B, H, W, inside_test: bool, origin=(0, 0),
                device="cpu"):
    """(crossings, least distance to the outline, the border width at
    the nearest edge), one polyline edge after the other."""
    x, y = _grid(H, W, origin, device)
    P1 = np.roll(P, -1, axis=0)
    cross = torch.zeros((H, W), dtype=torch.int32, device=device)
    dmin = torch.full((H, W), float("inf"), device=device)
    bsel = torch.zeros((H, W), device=device)
    for p0, p1, bw in zip(P, P1, B):
        ex, ey = p1[0] - p0[0], p1[1] - p0[1]
        L2 = float(max(ex * ex + ey * ey, F32(1e-12)))
        px, py, ex_, ey_ = float(p0[0]), float(p0[1]), float(ex), float(ey)
        t = torch.clamp(fdiv((x - px) * ex_ + (y - py) * ey_, L2), 0.0, 1.0)
        qx = px + t * ex_
        qy = py + t * ey_
        d = torch.sqrt(_sq(x - qx) + _sq(y - qy))
        closer = d < dmin
        dmin = torch.where(closer, d, dmin)
        bsel = torch.where(closer, float(bw), bsel)
        if inside_test:
            # even-odd crossings of a ray to +x
            cond = (py > y) != (float(p1[1]) > y)
            den = float(F32(1e-12) if abs(ey) < F32(1e-12) else ey)
            xint = px + fdiv(y - py, den) * ex_
            cross = cross + (cond & (xint > x)).to(torch.int32)
    return cross, dmin, bsel


def _polygon_mask(nodes, H, W, nh, nw, origin=(0, 0), device="cpu"):
    """A filled bezier path with per-node feathering (masks/polygon.c):
    the outline sampled on the host, f^2 over the border width."""
    P, B = _bezier_polyline(nodes, nh, nw)
    cross, dmin, bsel = _scan_edges(P, B, H, W, True, origin, device)
    inside = (cross % 2) == 1
    f = torch.clamp(1.0 - dmin / torch.clamp(bsel, min=1e-3), 0.0, 1.0)
    return torch.where(inside, 1.0, f * f)


def _brush_mask(nodes, H, W, nh, nw, origin=(0, 0), device="cpu"):
    """A brush stroke: the capsule falloff around the sampled bezier
    centreline with the nodes' mean density and hardness
    (masks/brush.c)."""
    # nodes: node2 ctrl1_2 ctrl2_2 border2 density hardness state
    poly_nodes = [n[:9] for n in nodes]
    P, B = _bezier_polyline(poly_nodes, nh, nw)
    density = float(np.mean([n[8] for n in nodes])) or 1.0
    hardness = float(np.mean([np.clip(n[9], 0.01, 1.0) for n in nodes]))
    _cross, dmin, bsel = _scan_edges(P, B, H, W, False, origin, device)
    r_in = bsel * hardness
    f = torch.clamp(1.0 - (dmin - r_in) / torch.clamp(bsel - r_in, min=1e-3),
                    0.0, 1.0)
    return torch.clamp(f * f * density, 0.0, 1.0)


def rasterize(form: Form, forms: Dict[int, Form], H: int, W: int,
              norm_h: int = 0, norm_w: int = 0, _depth: int = 0,
              origin=(0, 0), device="cpu") -> torch.Tensor:
    """-> (H, W) float32 mask in [0, 1] on `device`.  (H, W) is the
    (padded) grid; normalised shape coordinates refer to (norm_h, norm_w),
    the image's valid size (default: the grid's); `origin` = (y0, x0),
    the grid's offset in the image (a window)."""
    nh, nw = norm_h or H, norm_w or W
    t = _base_type(form.type)
    args = (H, W, nh, nw, origin, device)
    if t == MASK_CIRCLE:
        return _circle_mask(form.nodes[0], *args)
    if t == MASK_ELLIPSE:
        return _ellipse_mask(form.nodes[0], *args)
    if t == MASK_GRADIENT:
        return _gradient_mask(form.nodes[0], *args)
    if t == MASK_POLYGON:
        return _polygon_mask(form.nodes, *args)
    if t == MASK_BRUSH:
        return _brush_mask(form.nodes, *args)
    mask = torch.zeros((H, W), dtype=torch.float32, device=device)
    if t != MASK_GROUP or _depth > 4:
        return mask
    for (formid, _parent, state, opacity) in form.nodes:
        sub = forms.get(formid)
        if sub is None:
            continue
        m = rasterize(sub, forms, H, W, nh, nw, _depth + 1, origin, device)
        if state & STATE_INVERSE:
            m = 1.0 - m
        m = m * float(F32(opacity))
        both = (mask > 0.0) & (m > 0.0)
        if state & STATE_INTERSECTION:
            mask = torch.where(both, torch.minimum(mask, m), 0.0)
        elif state & STATE_DIFFERENCE:
            mask = torch.where(both, mask * (1.0 - m), mask)
        elif state & STATE_EXCLUSION:
            mask = torch.where(
                both, torch.maximum((1.0 - mask) * m, mask * (1.0 - m)),
                torch.maximum(mask, m))
        else:  # union (the default)
            mask = torch.maximum(mask, m)
    return mask


def form_bbox(form: Optional[Form], forms: Dict[int, Form],
              nh: int, nw: int, _depth: int = 0):
    """The host-side bounding box of a form's support in pixels: (y0, y1,
    x0, x1) half-open and unclamped, or None where the support is
    unbounded (a gradient, an inverted member, a group too deep), as the
    rasterisers' falloffs reach (each shape's *_get_area in
    src/develop/masks/*.c)."""
    if form is None or not form.nodes:
        return None
    t = _base_type(form.type)
    mind = float(min(nw, nh))
    if t == MASK_CIRCLE:
        cx, cy, radius, border = form.nodes[0][:4]
        r = (float(radius) + float(border)) * mind
        return (int(np.floor(cy * nh - r)), int(np.ceil(cy * nh + r)) + 1,
                int(np.floor(cx * nw - r)), int(np.ceil(cx * nw + r)) + 1)
    if t == MASK_ELLIPSE:
        cx, cy, r0, r1, _rot, border = form.nodes[0][:6]
        flags = int(form.nodes[0][6])
        if flags & ELLIPSE_PROPORTIONAL:
            t0, t1 = r0 * (1.0 + border), r1 * (1.0 + border)
        else:
            t0, t1 = r0 + border, r1 + border
        r = max(float(t0), float(t1)) * mind  # the outer radius, any rotation
        return (int(np.floor(cy * nh - r)), int(np.ceil(cy * nh + r)) + 1,
                int(np.floor(cx * nw - r)), int(np.ceil(cx * nw + r)) + 1)
    if t in (MASK_POLYGON, MASK_BRUSH):
        nodes = form.nodes if t == MASK_POLYGON else [n[:9]
                                                      for n in form.nodes]
        P, B = _bezier_polyline(nodes, nh, nw)
        b = float(np.max(B))
        return (int(np.floor(P[:, 1].min() - b)),
                int(np.ceil(P[:, 1].max() + b)) + 1,
                int(np.floor(P[:, 0].min() - b)),
                int(np.ceil(P[:, 0].max() + b)) + 1)
    if t == MASK_GROUP:
        if _depth > 4:
            return None
        box = None
        for (formid, _parent, state, _opacity) in form.nodes:
            if state & STATE_INVERSE:
                return None
            sub = form_bbox(forms.get(formid), forms, nh, nw, _depth + 1)
            if sub is None:
                return None
            box = sub if box is None else (
                min(box[0], sub[0]), max(box[1], sub[1]),
                min(box[2], sub[2]), max(box[3], sub[3]))
        return box
    return None  # a gradient: unbounded


def form_signature(form: Optional[Form], forms: Dict[int, Form]) -> tuple:
    """A form's geometry as a hashable digest: it keys the pipe cache, as
    the JAX package keys its compile cache with it."""
    if form is None:
        return ()
    t = _base_type(form.type)
    if t == MASK_GROUP:
        return (t,) + tuple(
            (fid, s, o) + form_signature(forms.get(fid), forms)
            for (fid, _p, s, o) in form.nodes)
    return (t,) + tuple(tuple(n) for n in form.nodes)
