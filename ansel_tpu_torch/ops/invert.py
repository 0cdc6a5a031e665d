"""invert — film negative inversion.

Reference: `ansel/src/iop/invert.c` (params v2: film material
color[4]): out = color - in, per CFA site colour on Bayer and X-Trans
mosaics, per channel on RGB.  Copied from `ansel_tpu/ops/invert.py`,
plain torch.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.params import cfield, params
from ..core.types import CFAPattern, Colorspace
from . import _bayer
from .base import Op, OpPlan, PlanContext, register


@params(op="invert", version=2)
@dataclasses.dataclass
class InvertParams:
    color: tuple = cfield("4f", (1.0, 1.0, 1.0, 1.0))


    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        # invert.c v1 {color[3]} -> 4th channel NaN (4Bayer CYGM path
        # needs the camera matrix; headless keeps NaN like the
        # reference's non-4bayer branch)
        if version == 1:
            r, g, b = struct.unpack("<3f", raw[:12])
            return cls(color=(r, g, b, float("nan")))
        return None


@register
class Invert(Op):
    name = "invert"
    input_colorspace = Colorspace.RAW

    def coeffs(self, ctx, plan, p):
        return {"color": list(p.color[:3]) + [p.color[1]]}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        spec = plan.spec_in
        if spec.colorspace is Colorspace.RAW and spec.cfa is not None:
            if spec.cfa is CFAPattern.XTRANS:
                m = _bayer.xtrans_color_select(c["color"][:3],
                                               ctx.meta.xtrans,
                                               spec.pad_h, spec.pad_w)
            else:
                m = _bayer.color_select(c["color"], spec.cfa,
                                        spec.pad_h, spec.pad_w)
            return torch.clamp(m - x, 0.0, 1.0)
        col = c["color"][:3].reshape(3, 1, 1)
        return torch.clamp(col - x, 0.0, 1.0)
