"""Windowed application of the drawn-mask tools (clone, heal, blur,
fill), as `ansel_tpu/ops/_maskwin.py` applies them.

The reference applies each form's tool over the form's region only
(`src/iop/retouch.c` rt_process_forms; `src/pixel/heal.c:314` solves the
window it is passed).  The form's support box is computed on the host
(`masks.form_bbox`), the tool runs on a window clamped so that it and
its clone source stay inside the image, and the result is pasted back
into a copy of the image.
"""

from __future__ import annotations

from ..pipeline import masks as mk

# a form larger than this share of the plane gains nothing from a
# window: the caller uses the whole plane
MAX_AREA_FRAC = 0.5


def plan_window(form, forms, spec, dy: int = 0, dx: int = 0,
                margin: int = 16):
    """-> (y0, y1, x0, x1), a window holding the form's support and
    `margin`, clamped so that it and its clone source (shifted by (dy,
    dx)) stay inside the image; None where the support is unbounded or
    too large.  Computed at plan time (it is part of OpPlan.static)."""
    H, W = spec.array_shape[-2], spec.array_shape[-1]
    box = mk.form_bbox(form, forms, spec.height, spec.width)
    if box is None:
        return None
    y0, y1, x0, x1 = box
    y0 -= margin
    x0 -= margin
    y1 += margin
    x1 += margin
    y0 = max(y0, 0, -dy)
    x0 = max(x0, 0, -dx)
    y1 = min(y1, H, H - dy)
    x1 = min(x1, W, W - dx)
    if y1 - y0 < 2 or x1 - x0 < 2:
        return None
    if (y1 - y0) * (x1 - x0) > MAX_AREA_FRAC * H * W:
        return None
    return (int(y0), int(y1), int(x0), int(x1))


def apply_windowed(x, form, forms, spec, win, tool, dy: int = 0,
                   dx: int = 0):
    """`tool(dst_win, src_win, mask_win) -> healed_win` on the window `win`
    of x (C, H, W), pasted into a copy of x.  src_win is the clone
    source's window (offset (dy, dx)); dst_win where (dy, dx) = (0, 0)."""
    y0, y1, x0, x1 = win
    dst = x[:, y0:y1, x0:x1]
    src = dst if (dy == 0 and dx == 0) else \
        x[:, y0 + dy:y1 + dy, x0 + dx:x1 + dx]
    m = mk.rasterize(form, forms, y1 - y0, x1 - x0,
                     norm_h=spec.height, norm_w=spec.width,
                     origin=(y0, x0), device=x.device)
    out = x.clone()
    out[:, y0:y1, x0:x1] = tool(dst, src, m)
    return out
