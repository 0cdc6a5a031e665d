"""velvia — saturation boost weighted toward unsaturated pixels.

Reference: `ansel/src/iop/velvia.c` (params v2 :73-77, process()
:100-140), as `ansel_tpu/ops/velvia.py` has it: an HSL-like saturation
estimate, a bias-weighted strength, and each channel pushed away from
the mean of the other two; display-referred RGB clamped to [0, 1].
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.params import cfield, params
from ..core.types import Colorspace
from ..kernels.pointwise import OP_VELVIA
from .base import Op, OpPlan, PlanContext, PointwiseSpec, register


@params(op="velvia", version=2)
@dataclasses.dataclass
class VelviaParams:
    strength: float = cfield("f", 25.0)
    bias: float = cfield("f", 1.0)


    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        # velvia.c v1 {saturation, vibrance, luminance, clarity}
        if version == 1:
            sat, vib, lum = struct.unpack("<3f", raw[:12])
            return cls(strength=sat * vib / 100.0, bias=lum)
        return None


@register
class Velvia(Op):
    name = "velvia"
    input_colorspace = Colorspace.WORK_RGB

    def coeffs(self, ctx, plan, p):
        return {"strength": p.strength / 100.0, "bias": p.bias}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        return _pixel(x, c)

    def pointwise_spec(self, plan, ctx):
        return PointwiseSpec(fn=_pixel, opcode=OP_VELVIA,
                             consts=("strength", "bias"))


def _pixel(x, c):
    strength, bias = c["strength"], c["bias"]
    pmax = torch.maximum(torch.maximum(x[0], x[1]), x[2])
    pmin = torch.minimum(torch.minimum(x[0], x[1]), x[2])
    plum = (pmax + pmin) * 0.5
    psat = torch.where(
        plum <= 0.5,
        (pmax - pmin) / (1e-5 + pmax + pmin),
        (pmax - pmin) / (1e-5 + torch.clamp(2.0 - pmax - pmin, min=0.0)))
    pweight = torch.clamp(
        ((1.0 - 1.5 * psat) + (1.0 + torch.abs(plum - 0.5) * 2.0)
         * (1.0 - bias)) / (1.0 + (1.0 - bias)), 0.0, 1.0)
    sat = strength * pweight
    total = (x[0] + x[1]) + x[2]
    return torch.stack([torch.clamp(x[i] + sat * (x[i] - (total - x[i]) * 0.5),
                                    0.0, 1.0) for i in range(3)])
