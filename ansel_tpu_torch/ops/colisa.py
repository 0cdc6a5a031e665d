"""colisa — contrast, brightness and saturation on Lab.

Reference: `ansel/src/iop/colisa.c` (params v1 :60-65, commit curves
:152-205, process), as `ansel_tpu/ops/colisa.py` has it: the curves in
closed form, a linear contrast slope around 50 when the contrast slider
is at or below 0 and a sigmoid above (a static branch of the plan), then
the brightness gamma; a and b scaled by the saturation.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..color.transforms import fdiv
from ..core.params import cfield, params
from ..core.types import Colorspace
from ..kernels.pointwise import OP_COLISA
from .base import Op, OpPlan, PlanContext, PointwiseSpec, register


@params(op="colisa", version=1)
@dataclasses.dataclass
class ColisaParams:
    contrast: float = cfield("f", 0.0)
    brightness: float = cfield("f", 0.0)
    saturation: float = cfield("f", 0.0)


_CONSTS = ("contrast", "m1sq", "scale", "gamma", "saturation")


@register
class Colisa(Op):
    name = "colisa"
    input_colorspace = Colorspace.LAB

    def plan(self, ctx: PlanContext, spec_in, p: ColisaParams) -> OpPlan:
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(p.contrast <= 0.0,))

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: ColisaParams):
        contrast = p.contrast + 1.0
        brightness = p.brightness * 2.0
        boost = 20.0
        m1sq = boost * (contrast - 1.0) ** 2
        return {
            "contrast": np.float32(contrast),
            "m1sq": np.float32(m1sq),
            "scale": np.float32((1.0 + m1sq) ** 0.5),
            "gamma": np.float32(1.0 / (1.0 + brightness)
                                if brightness >= 0.0 else 1.0 - brightness),
            "saturation": np.float32(p.saturation + 1.0),
        }

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        return _pixel(x, c, plan.static[0])

    def pointwise_spec(self, plan, ctx):
        (linear,) = plan.static
        return PointwiseSpec(fn=lambda x, c: _pixel(x, c, linear),
                             opcode=OP_COLISA, consts=_CONSTS,
                             ints=(int(linear),))


def _pixel(x, c, linear_contrast):
    t = fdiv(x[0], 100.0)
    if linear_contrast:
        # colisa.c:167 — linear slope around 50
        L = c["contrast"] * (100.0 * t - 50.0) + 50.0
    else:
        # colisa.c:178-179 — sigmoid
        k = 2.0 * t - 1.0
        L = 50.0 * (c["scale"] * k / torch.sqrt(1.0 + c["m1sq"] * k * k)
                    + 1.0)
    # brightness gamma (colisa.c:193-196)
    L = 100.0 * torch.clamp(fdiv(L, 100.0), min=0.0) ** c["gamma"]
    return torch.stack([L, x[1] * c["saturation"], x[2] * c["saturation"]])
