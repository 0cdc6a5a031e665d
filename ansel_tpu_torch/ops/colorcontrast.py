"""colorcontrast — steepness and offset of Lab a and b.

Reference: `ansel/src/iop/colorcontrast.c` (params v2 :71-78, process
:100-140), as `ansel_tpu/ops/colorcontrast.py` has it: a' = a steepness
+ offset, the same for b, clamped to ±128 unless unbound.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.params import cfield, params
from ..core.types import Colorspace
from ..kernels.pointwise import OP_COLORCONTRAST
from .base import Op, OpPlan, PlanContext, PointwiseSpec, register


@params(op="colorcontrast", version=2)
@dataclasses.dataclass
class ColorContrastParams:
    a_steepness: float = cfield("f", 1.0)
    a_offset: float = cfield("f", 0.0)
    b_steepness: float = cfield("f", 1.0)
    b_offset: float = cfield("f", 0.0)
    unbound: int = cfield("i", 1)


    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        # colorcontrast.c v1 = v2 without unbound (clipped behavior)
        if version == 1:
            a_s, a_o, b_s, b_o = struct.unpack("<4f", raw[:16])
            return cls(a_steepness=a_s, a_offset=a_o, b_steepness=b_s,
                       b_offset=b_o, unbound=0)
        return None


@register
class ColorContrast(Op):
    name = "colorcontrast"
    input_colorspace = Colorspace.LAB

    def coeffs(self, ctx, plan, p):
        return {"slope": [1.0, p.a_steepness, p.b_steepness],
                "offset": [0.0, p.a_offset, p.b_offset]}

    def plan(self, ctx, spec_in, p):
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=bool(p.unbound))

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        return _pixel(x, c, plan.static)

    def pointwise_spec(self, plan, ctx):
        unbound = plan.static
        return PointwiseSpec(fn=lambda x, c: _pixel(x, c, unbound),
                             opcode=OP_COLORCONTRAST,
                             consts=("slope", "offset"),
                             ints=(int(unbound),))


def _pixel(x, c, unbound):
    sl, of = c["slope"], c["offset"]
    y = [x[i] * sl[i] + of[i] for i in range(3)]
    if not unbound:
        y = [y[0], torch.clamp(y[1], -128.0, 128.0),
             torch.clamp(y[2], -128.0, 128.0)]
    return torch.stack(y)
