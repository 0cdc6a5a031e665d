"""highpass — inverted-blur overlay high-pass filter in Lab.

Reference: `ansel/src/iop/highpass.c` (params v1, highpass.c:71-75;
process: invert L, iterated box-mean blur with the radius from
sharpness, blend 50/50 with the original L, contrast boost around 50,
a/b set to 0).  Planning is copied from `ansel_tpu/ops/highpass.py`.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.params import cfield, params
from ..core.types import Colorspace
from ..pixel.blur import box_blur
from .base import Op, OpPlan, PlanContext, register

MAX_RADIUS = 256
BOX_ITERATIONS = 8


@params(op="highpass", version=1)
@dataclasses.dataclass
class HighpassParams:
    sharpness: float = cfield("f", 50.0)
    contrast: float = cfield("f", 50.0)


@register
class Highpass(Op):
    name = "highpass"
    input_colorspace = Colorspace.LAB

    def plan(self, ctx: PlanContext, spec_in, p: HighpassParams) -> OpPlan:
        rad = MAX_RADIUS * (min(100.0, p.sharpness + 1.0) / 100.0)
        radius = min(MAX_RADIUS, int(-(-rad * ctx.scale // 1)))
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=max(1, (2 * radius + 1) // 2))

    def coeffs(self, ctx, plan, p):
        return {"contrast_scale": (p.contrast / 100.0) * 7.5}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        inv = 100.0 - torch.clamp(x[0], 0.0, 100.0)
        for _ in range(BOX_ITERATIONS):
            inv = box_blur(inv, plan.static)
        L = inv * 0.5 + x[0] * 0.5
        L = torch.clamp(50.0 + (L - 50.0) * c["contrast_scale"], 0.0, 100.0)
        z = torch.zeros_like(L)
        return torch.stack([L, z, z])
