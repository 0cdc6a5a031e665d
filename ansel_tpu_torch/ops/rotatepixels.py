"""rotatepixels — fixed sensor rotation correction (e.g. Fuji DR sensors
mounted at 45 degrees).

Reference: `ansel/src/iop/rotatepixels.c` — params v1 (:54-58): rotation
by `angle` around the sensor point (rx, ry).  As in
`ansel_tpu/ops/rotatepixels.py`, an inverse-map bilinear gather in plain
torch (the JAX package runs it outside any Pallas kernel), with the lens
warp's sampler (`kernels/warp.sample_bilinear`).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core.params import cfield, params
from ..kernels.warp import sample_bilinear
from .base import Op, OpPlan, PlanContext, register


@params(op="rotatepixels", version=1)
@dataclasses.dataclass
class RotatePixelsParams:
    rx: int = cfield("I", 0)
    ry: int = cfield("I", 0)
    angle: float = cfield("f", 0.0)


@register
class RotatePixels(Op):
    name = "rotatepixels"
    input_colorspace = None

    def enabled_by_default(self, meta):
        return False

    def plan(self, ctx: PlanContext, spec_in,
             p: RotatePixelsParams) -> OpPlan:
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(float(p.angle), float(p.rx), float(p.ry)))

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        angle, rx, ry = plan.static
        if abs(angle) < 1e-9:
            return x
        h, w = x.shape[-2:]
        a = math.radians(angle)
        ca, sa = math.cos(a), math.sin(a)
        ys = torch.arange(h, dtype=torch.float32, device=x.device)[:, None] - ry
        xs = torch.arange(w, dtype=torch.float32, device=x.device)[None, :] - rx
        src_x = (ca * xs + sa * ys + rx).expand(h, w)
        src_y = (-sa * xs + ca * ys + ry).expand(h, w)
        return torch.stack([sample_bilinear(x[i], src_y, src_x)
                            for i in range(x.shape[0])])
