"""hotpixels — dead/hot photosite suppression on the mosaic.

Reference: `ansel/src/iop/hotpixels.c` (params v1, hotpixels.c:74-80;
bayer kernel :161-193): a site above `threshold` whose value*strength/2
exceeds >= 3 (permissive) or 4 same-color neighbours at ±2 is replaced
by the largest of those dimmer neighbours.  Planning and coefficients
are copied from `ansel_tpu/ops/hotpixels.py`; the neighbours are
shifted views of one padded copy (`pixel/shifts.PaddedView`).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.params import cfield, params
from ..core.types import Colorspace
from ..pixel.shifts import PaddedView
from .base import Op, OpPlan, PlanContext, register


@params(op="hotpixels", version=1)
@dataclasses.dataclass
class HotPixelsParams:
    strength: float = cfield("f", 0.25)
    threshold: float = cfield("f", 0.05)
    markfixed: int = cfield("i", 0)
    permissive: int = cfield("i", 0)


@register
class HotPixels(Op):
    name = "hotpixels"
    # +-2 mosaic stencil; 6 keeps window origins CFA-period aligned
    window_halo = 6
    input_colorspace = Colorspace.RAW

    def plan(self, ctx: PlanContext, spec_in, p) -> OpPlan:
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=3 if p.permissive else 4)

    def coeffs(self, ctx, plan, p):
        return {"multiplier": p.strength / 2.0, "threshold": p.threshold}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        min_n = plan.static
        mid = x * c["multiplier"]
        pv = PaddedView(x, 2)
        neighbours = [pv.at(dy, dx) for dy, dx in
                      ((0, 2), (0, -2), (2, 0), (-2, 0))]
        count = sum((n < mid).to(torch.int32) for n in neighbours)
        maxin = torch.zeros_like(x)
        for n in neighbours:
            maxin = torch.where((n < mid) & (n > maxin), n, maxin)
        fix = (x > c["threshold"]) & (count >= min_n)
        return torch.where(fix, maxin, x)
