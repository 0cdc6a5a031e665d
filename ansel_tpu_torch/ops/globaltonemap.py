"""globaltonemap — Reinhard, Drago and filmic global operators on L.

Reference: `ansel/src/iop/globaltonemap.c` (params v3 :73-82; Reinhard
:158-176, Drago :179-255, filmic :258-276).  As in
`ansel_tpu/ops/globaltonemap.py`, whose planning, coefficients and v1/v2
ladder are copied here: Drago takes the frame's largest L by a reduction
on the device, and the detail layer comes from a guided filter on L
(`pixel/guided.guided_filter`) where the reference uses a bilateral
grid.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.params import cfield, params
from ..core.types import Colorspace
from ..pixel.guided import guided_filter
from .base import Op, OpPlan, PlanContext, register

OP_REINHARD = 0
OP_FILMIC = 1
OP_DRAGO = 2


@params(op="globaltonemap", version=3)
@dataclasses.dataclass
class GlobalTonemapParams:
    operator: int = cfield("i", OP_DRAGO)
    drago_bias: float = cfield("f", 0.85)
    drago_max_light: float = cfield("f", 100.0)
    detail: float = cfield("f", 0.0)

    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        # globaltonemap.c v1/v2 -> appended detail = 0
        if version in (1, 2):
            op, bias, maxl = struct.unpack("<i2f", raw[:12])
            return cls(operator=op, drago_bias=bias,
                       drago_max_light=maxl, detail=0.0)
        return None


@register
class GlobalTonemap(Op):
    name = "globaltonemap"
    input_colorspace = Colorspace.LAB

    def plan(self, ctx: PlanContext, spec_in, p: GlobalTonemapParams) -> OpPlan:
        sigma_s = max(int(min(spec_in.width, spec_in.height) * 0.03), 1)
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(p.operator, p.detail != 0.0, sigma_s))

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: GlobalTonemapParams):
        return {
            "bias_log": np.float32(math.log(max(1e-4, p.drago_bias))
                                   / math.log(0.5)),
            "max_light": np.float32(p.drago_max_light),
            "detail": np.float32(p.detail),
        }

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        operator, has_detail, sigma_s = plan.static
        L_in = x[0]
        l = L_in / 100.0
        eps = 1e-4
        if operator == OP_REINHARD:
            L = 100.0 * (l / (1.0 + l))
        elif operator == OP_FILMIC:
            t = torch.clamp(l - 0.004, min=0.0)
            L = 100.0 * ((t * (6.2 * t + 0.5)) / (t * (6.2 * t + 1.7) + 0.06))
        else:  # Drago (globaltonemap.c:242-255)
            log10 = torch.log(torch.full((), 10.0, device=x.device))
            lwmax = torch.clamp(torch.amax(l), min=eps)
            ldc = c["max_light"] * 0.01 / (torch.log(lwmax + 1.0) / log10)
            L = 100.0 * (ldc * torch.log(torch.clamp(l + 1.0, min=eps))
                         / torch.log(torch.clamp(
                             2.0 + ((l / lwmax) ** c["bias_log"]) * 8.0,
                             min=eps)))
        if has_detail:
            base = guided_filter(L_in, L_in, sigma_s, 64.0)
            L = L + c["detail"] * (L_in - base)
        return torch.stack([L, x[1], x[2]])
