"""colorcorrection — split-tone white balance in Lab a and b.

Reference: `ansel/src/iop/colorcorrection.c` (params v1 :76-80,
process), as `ansel_tpu/ops/colorcorrection.py` has it:
a' = sat (a + L (hia - loa) / 100 + loa), the same for b.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.params import cfield, params
from ..core.types import Colorspace
from ..kernels.pointwise import OP_COLORCORRECTION
from .base import Op, OpPlan, PlanContext, PointwiseSpec, register


@params(op="colorcorrection", version=1)
@dataclasses.dataclass
class ColorCorrectionParams:
    hia: float = cfield("f", 0.0)
    hib: float = cfield("f", 0.0)
    loa: float = cfield("f", 0.0)
    lob: float = cfield("f", 0.0)
    saturation: float = cfield("f", 1.0)


_CONSTS = ("a_scale", "a_base", "b_scale", "b_base", "saturation")


@register
class ColorCorrection(Op):
    name = "colorcorrection"
    input_colorspace = Colorspace.LAB

    def coeffs(self, ctx, plan, p):
        return {"a_scale": (p.hia - p.loa) / 100.0, "a_base": p.loa,
                "b_scale": (p.hib - p.lob) / 100.0, "b_base": p.lob,
                "saturation": p.saturation}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        return _pixel(x, c)

    def pointwise_spec(self, plan, ctx):
        return PointwiseSpec(fn=_pixel, opcode=OP_COLORCORRECTION,
                             consts=_CONSTS)


def _pixel(x, c):
    sat = c["saturation"]
    a = sat * (x[1] + x[0] * c["a_scale"] + c["a_base"])
    b = sat * (x[2] + x[0] * c["b_scale"] + c["b_base"])
    return torch.stack([x[0], a, b])
