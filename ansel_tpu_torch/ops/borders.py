"""borders — framed border around the picture.

Reference: `ansel/src/iop/borders.c` (params v3, borders.c:92-118):
border `size` relative to the frame, optional aspect target, picture
offset within the frame, optional frame line with its own colour and
offset.  Geometry-extending op (modify_roi_out grows the canvas; as in
the JAX package, `spec_in.with_size` keeps the frame's full_h/full_w).
Copied from `ansel_tpu/ops/borders.py`: the canvas is the output's padded
array, filled in plain torch.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.params import cfield, params
from ..core.types import Colorspace, ImageSpec
from .base import Op, OpPlan, PlanContext, register


@params(op="borders", version=3)
@dataclasses.dataclass
class BordersParams:
    color: tuple = cfield("3f", (1.0, 1.0, 1.0))
    aspect: float = cfield("f", -1.0)
    aspect_text: str = cfield("s:20", "constant border")
    aspect_orient: int = cfield("i", 0)
    size: float = cfield("f", 0.1)
    pos_h: float = cfield("f", 0.5)
    pos_h_text: str = cfield("s:20", "1/2")
    pos_v: float = cfield("f", 0.5)
    pos_v_text: str = cfield("s:20", "1/2")
    frame_size: float = cfield("f", 0.0)
    frame_offset: float = cfield("f", 0.5)
    frame_color: tuple = cfield("3f", (0.0, 0.0, 0.0))
    max_border_size: int = cfield("i", 1)


    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        # borders.c ladder (:151-210)
        if version == 1:  # {color[3], aspect, size}
            r, g, b, aspect, size = struct.unpack("<5f", raw[:20])
            return cls(color=(r, g, b),
                       aspect=(1.0 / aspect if aspect < 1 else aspect),
                       aspect_orient=1 if aspect > 1 else 2,
                       size=abs(size), max_border_size=0)
        if version == 2:  # current struct minus max_border_size
            v = struct.unpack("<4f20si2f20sf20s2f3f", raw[:112])
            return cls(color=tuple(v[0:3]), aspect=v[3],
                       aspect_text=v[4].split(b"\x00")[0].decode(),
                       aspect_orient=v[5], size=v[6], pos_h=v[7],
                       pos_h_text=v[8].split(b"\x00")[0].decode(),
                       pos_v=v[9],
                       pos_v_text=v[10].split(b"\x00")[0].decode(),
                       frame_size=v[11], frame_offset=v[12],
                       frame_color=tuple(v[13:16]), max_border_size=0)
        return None


@register
class Borders(Op):
    name = "borders"
    input_colorspace = None

    def plan(self, ctx: PlanContext, spec_in: ImageSpec, p: BordersParams) -> OpPlan:
        iw, ih = spec_in.width, spec_in.height
        size = min(max(p.size, 0.0), 0.5)
        if p.aspect <= 0:  # constant border
            bw = int(round(iw * size / (1.0 - 2.0 * size)))
            bh = int(round(ih * size / (1.0 - 2.0 * size)))
            ow, oh = iw + 2 * bw, ih + 2 * bh
        else:
            aspect = p.aspect if p.aspect_orient == 0 else 1.0 / p.aspect
            ow = max(iw, int(round(ih * aspect)))
            oh = max(ih, int(round(iw / aspect)))
            ow = int(round(ow / (1.0 - 2.0 * size)))
            oh = int(round(oh / (1.0 - 2.0 * size)))
        x0 = int(round((ow - iw) * min(max(p.pos_h, 0.0), 1.0)))
        y0 = int(round((oh - ih) * min(max(p.pos_v, 0.0), 1.0)))
        spec_out = spec_in.with_size(ow, oh)
        return OpPlan(spec_in=spec_in, spec_out=spec_out,
                      static=(x0, y0, round(p.frame_size, 5),
                              round(p.frame_offset, 5)))

    def coeffs(self, ctx, plan, p):
        return {"color": list(p.color), "frame_color": list(p.frame_color)}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        x0, y0, frame_size, frame_offset = plan.static
        si, so = plan.spec_in, plan.spec_out
        color = c["color"].to(x.dtype).reshape(3, 1, 1)
        canvas = color.expand(3, so.pad_h, so.pad_w).clone()
        canvas[:, y0:y0 + si.height, x0:x0 + si.width] = \
            x[:, : si.height, : si.width]
        if frame_size > 0.0:
            # frame line: a rectangle between picture and outer edge
            border = max(min(x0, y0), 1)
            fw = max(1, int(round(frame_size * border)))
            off = int(round(frame_offset * max(border - fw, 0)))
            fx0, fy0 = x0 - off - fw, y0 - off - fw
            fx1 = x0 + si.width + off + fw
            fy1 = y0 + si.height + off + fw
            ii = torch.arange(so.pad_h, device=x.device)[:, None]
            jj = torch.arange(so.pad_w, device=x.device)[None, :]
            outer = ((ii >= fy0) & (ii < fy1) & (jj >= fx0) & (jj < fx1))
            inner = ((ii >= fy0 + fw) & (ii < fy1 - fw)
                     & (jj >= fx0 + fw) & (jj < fx1 - fw))
            ring = outer & ~inner
            fcol = c["frame_color"].to(x.dtype).reshape(3, 1, 1)
            canvas = torch.where(ring[None], fcol, canvas)
        return canvas
