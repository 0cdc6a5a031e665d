"""vibrance — chroma-weighted saturation in Lab.

Reference: `ansel/src/iop/vibrance.c` (params v2, process()), as
`ansel_tpu/ops/vibrance.py` has it: the weight sw = |ab| / 256, L scaled
by 1 - amount sw / 4, a and b by 1 + amount sw.
"""

from __future__ import annotations

import dataclasses

import torch

from ..color.transforms import fdiv
from ..core.params import cfield, params
from ..core.types import Colorspace
from ..kernels.pointwise import OP_VIBRANCE
from .base import Op, OpPlan, PlanContext, PointwiseSpec, register


@params(op="vibrance", version=2)
@dataclasses.dataclass
class VibranceParams:
    amount: float = cfield("f", 25.0)


@register
class Vibrance(Op):
    name = "vibrance"
    input_colorspace = Colorspace.LAB

    def coeffs(self, ctx, plan, p):
        return {"amount": p.amount * 0.01}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        return _pixel(x, c)

    def pointwise_spec(self, plan, ctx):
        return PointwiseSpec(fn=_pixel, opcode=OP_VIBRANCE,
                             consts=("amount",))


def _pixel(x, c):
    amount = c["amount"]
    sw = fdiv(torch.sqrt(x[1] * x[1] + x[2] * x[2]), 256.0)
    ls = 1.0 - amount * sw * 0.25
    ss = 1.0 + amount * sw
    return torch.stack([x[0] * ls, x[1] * ss, x[2] * ss])
