"""crop — relative-coordinate crop (the modern module; `clipping` adds
rotation and keystone).

Reference: `ansel/src/iop/crop.c` (params v1: cx/cy/cw/ch in [0, 1]
fractions of the incoming ROI).  Copied from `ansel_tpu/ops/crop.py`.
"""

from __future__ import annotations

import dataclasses

from ..core.params import cfield, params
from ..core.types import ImageSpec
from ..pixel.shifts import pad_tail
from .base import Op, OpPlan, PlanContext, register


@params(op="crop", version=1)
@dataclasses.dataclass
class CropParams:
    cx: float = cfield("f", 0.0)
    cy: float = cfield("f", 0.0)
    cw: float = cfield("f", 1.0)
    ch: float = cfield("f", 1.0)
    ratio_n: int = cfield("i", -1)
    ratio_d: int = cfield("i", -1)


@register
class Crop(Op):
    name = "crop"
    input_colorspace = None

    def plan(self, ctx: PlanContext, spec_in: ImageSpec,
             p: CropParams) -> OpPlan:
        x0 = int(round(p.cx * spec_in.width))
        y0 = int(round(p.cy * spec_in.height))
        x1 = max(x0 + 1, int(round(p.cw * spec_in.width)))
        y1 = max(y0 + 1, int(round(p.ch * spec_in.height)))
        spec_out = spec_in.with_size(x1 - x0, y1 - y0)
        return OpPlan(spec_in=spec_in, spec_out=spec_out, static=(x0, y0))

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        x0, y0 = plan.static
        so = plan.spec_out
        v = x[..., y0: y0 + so.height, x0: x0 + so.width]
        return pad_tail(v, so.pad_h - v.shape[-2],
                        so.pad_w - v.shape[-1]).contiguous()
