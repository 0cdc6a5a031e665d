"""sharpen — unsharp mask on Lab L.

Reference: `ansel/src/iop/sharpen.c` (params v1, sharpen.c:83-88): a
separable Gaussian blur of L (sigma = radius * scale / 2.5, through
`pixel/blur.gaussian_blur`: the sepblur kernel), detail = the soft
threshold of (L - blur), L + amount * detail; a/b untouched.  Planning
is copied from `ansel_tpu/ops/sharpen.py`.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.params import cfield, params
from ..core.types import Colorspace
from ..pixel.blur import gaussian_blur
from .base import Op, OpPlan, PlanContext, register


@params(op="sharpen", version=1)
@dataclasses.dataclass
class SharpenParams:
    radius: float = cfield("f", 2.0)
    amount: float = cfield("f", 0.5)
    threshold: float = cfield("f", 0.5)


@register
class Sharpen(Op):
    name = "sharpen"
    input_colorspace = Colorspace.LAB

    def plan(self, ctx: PlanContext, spec_in, p: SharpenParams) -> OpPlan:
        sigma = max(p.radius * ctx.scale / 2.5, 1e-3)
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=round(sigma, 4))

    def coeffs(self, ctx, plan, p):
        return {"amount": p.amount, "threshold": p.threshold}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        blur = gaussian_blur(x[0], plan.static)
        diff = x[0] - blur
        detail = torch.sign(diff) * torch.clamp(
            torch.abs(diff) - c["threshold"], min=0.0)
        L = x[0] + c["amount"] * detail
        return torch.stack([L, x[1], x[2]])
