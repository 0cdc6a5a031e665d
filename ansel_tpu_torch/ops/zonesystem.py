"""zonesystem — Ansel Adams zone remapping of Lab L.

Reference: `ansel/src/iop/zonesystem.c` (params v1, zonesystem.c:88-92),
as `ansel_tpu/ops/zonesystem.py` has it: `size` zones over L in [0, 100],
L remapped piecewise-linearly through the user's zone boundaries, a and
b scaled by the ratio.  Plain torch (the JAX package gives it no
pointwise form either).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.params import cfield, params
from ..core.types import Colorspace
from ..pixel.curves import eval_linear
from .base import Op, OpPlan, PlanContext, register

MAX_ZONES = 24


@params(op="zonesystem", version=1)
@dataclasses.dataclass
class ZoneSystemParams:
    size: int = cfield("i", 10)
    zone: tuple = cfield(f"{MAX_ZONES + 1}f", (-1.0,) * (MAX_ZONES + 1))


@register
class ZoneSystem(Op):
    name = "zonesystem"
    input_colorspace = Colorspace.LAB

    def plan(self, ctx: PlanContext, spec_in, p) -> OpPlan:
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=max(2, min(p.size, MAX_ZONES)))

    def coeffs(self, ctx, plan, p: ZoneSystemParams):
        size = plan.static
        # zonemap: boundaries default to uniform; user values override
        zonemap = np.array(
            [p.zone[k] if p.zone[k] >= 0 else k / (size - 1.0)
             for k in range(size)], np.float32)
        xs = np.linspace(0.0, 1.0, size).astype(np.float32)
        return {"xs": xs, "ys": zonemap}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        L = torch.clamp(x[0] / 100.0, 0.0, 1.0)
        L_out = eval_linear(L, c["xs"], c["ys"]) * 100.0
        ratio = L_out / torch.clamp(x[0], min=1e-6)
        return torch.stack([L_out, x[1] * ratio, x[2] * ratio])
