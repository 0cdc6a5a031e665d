"""soften — Orton-effect glow.

Reference: `ansel/src/iop/soften.c` (params v1, soften.c:73-79): a
brightened, saturation-scaled HSL copy, blurred (radius ~1% of the
diagonal scaled by size), then a linear blend with the original by
`amount`.  As in `ansel_tpu/ops/soften.py`, the 8 iterated box means are
one Gaussian of the equivalent sigma (the reference's GPU path,
soften.c:184), `pixel/blur.gaussian_blur`.  Planning is copied.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core.params import cfield, params
from ..core.types import Colorspace
from ..pixel.blur import gaussian_blur
from ._hsl import hsl_to_rgb, rgb_to_hsl
from .base import Op, OpPlan, PlanContext, register

BOX_ITERATIONS = 8


@params(op="soften", version=1)
@dataclasses.dataclass
class SoftenParams:
    size: float = cfield("f", 50.0)
    saturation: float = cfield("f", 100.0)
    brightness: float = cfield("f", 0.33)
    amount: float = cfield("f", 50.0)


@register
class Soften(Op):
    name = "soften"
    input_colorspace = Colorspace.WORK_RGB

    def plan(self, ctx: PlanContext, spec_in, p: SoftenParams) -> OpPlan:
        diag = math.hypot(spec_in.width, spec_in.height)
        mrad = diag * 0.01
        rad = mrad * (min(100.0, p.size + 1.0) / 100.0)
        radius = max(1, min(int(mrad), int(math.ceil(rad * ctx.scale))))
        return OpPlan(spec_in=spec_in, spec_out=spec_in, static=radius)

    def coeffs(self, ctx, plan, p):
        return {"brightness": 2.0**p.brightness,
                "saturation": p.saturation / 100.0,
                "amount": p.amount / 100.0}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        h, s, l = rgb_to_hsl(torch.clamp(x, 0.0, 1.0))
        glow = hsl_to_rgb(h, torch.clamp(s * c["saturation"], 0.0, 1.0),
                          torch.clamp(l * c["brightness"], 0.0, 1.0))
        r = plan.static
        sigma = math.sqrt((r * (r + 1.0) * BOX_ITERATIONS + 2.0) / 3.0)
        glow = gaussian_blur(glow, sigma)
        amt = c["amount"]
        return x * (1.0 - amt) + glow * amt
