"""bloom — highlight glow by screen-blending blurred bright L.

Reference: `ansel/src/iop/bloom.c` (params v1, bloom.c:71-76; process:
scale L by strength gain, keep only values above threshold, iterated
box-mean blur, screen blend onto L).  Planning and coefficients are
copied from `ansel_tpu/ops/bloom.py`; the eight box means at the default
radius of 54 run as cumulative sums (`pixel/blur.box_blur`).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core.params import cfield, params
from ..core.types import Colorspace
from ..pixel.blur import box_blur
from .base import Op, OpPlan, PlanContext, register

BOX_ITERATIONS = 8


@params(op="bloom", version=1)
@dataclasses.dataclass
class BloomParams:
    size: float = cfield("f", 20.0)
    threshold: float = cfield("f", 90.0)
    strength: float = cfield("f", 25.0)


@register
class Bloom(Op):
    name = "bloom"
    input_colorspace = Colorspace.LAB

    def plan(self, ctx: PlanContext, spec_in, p: BloomParams) -> OpPlan:
        rad = 256.0 * (min(100.0, p.size + 1.0) / 100.0)
        radius = min(256, int(math.ceil(rad * ctx.scale)))
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=max(1, (2 * radius + 1) // 2))

    def coeffs(self, ctx, plan, p):
        return {"scale": 2.0 ** (min(100.0, p.strength + 1.0) / 100.0),
                "threshold": p.threshold}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        L = x[0] * c["scale"]
        bl = torch.where(L > c["threshold"], L, 0.0)
        for _ in range(BOX_ITERATIONS):
            bl = box_blur(bl, plan.static)
        L_out = 100.0 - ((100.0 - x[0]) * (100.0 - bl)) / 100.0
        return torch.stack([L_out, x[1], x[2]])
