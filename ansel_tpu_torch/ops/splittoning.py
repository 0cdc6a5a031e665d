"""splittoning — tint shadows and highlights with chosen hues.

Reference: `ansel/src/iop/splittoning.c` (params v1 :89-97, process), as
`ansel_tpu/ops/splittoning.py` has it: the pixel's HSL lightness picks
the shadow or highlight zone around `balance` with a `compress` dead
band, and the pixel is mixed linearly toward hsl(hue, saturation, L);
display-referred RGB.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.params import cfield, params
from ..core.types import Colorspace
from ..kernels.pointwise import OP_SPLITTONING
from ._hsl import hsl_to_rgb
from .base import Op, OpPlan, PlanContext, PointwiseSpec, register


@params(op="splittoning", version=1)
@dataclasses.dataclass
class SplitToningParams:
    shadow_hue: float = cfield("f", 0.0)
    shadow_saturation: float = cfield("f", 0.5)
    highlight_hue: float = cfield("f", 0.2)
    highlight_saturation: float = cfield("f", 0.5)
    balance: float = cfield("f", 0.5)
    compress: float = cfield("f", 33.0)


_CONSTS = ("shadow_hue", "shadow_sat", "hl_hue", "hl_sat", "balance",
           "compress")


@register
class SplitToning(Op):
    name = "splittoning"
    input_colorspace = Colorspace.WORK_RGB

    def coeffs(self, ctx, plan, p):
        return {"shadow_hue": p.shadow_hue, "shadow_sat": p.shadow_saturation,
                "hl_hue": p.highlight_hue, "hl_sat": p.highlight_saturation,
                "balance": p.balance,
                "compress": (p.compress / 110.0) / 2.0}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        return _pixel(x, c)

    def pointwise_spec(self, plan, ctx):
        return PointwiseSpec(fn=_pixel, opcode=OP_SPLITTONING,
                             consts=_CONSTS)


def _pixel(x, c):
    xc = torch.clamp(x, 0.0, 1.0)
    mx = torch.maximum(torch.maximum(xc[0], xc[1]), xc[2])
    mn = torch.minimum(torch.minimum(xc[0], xc[1]), xc[2])
    l = (mx + mn) * 0.5
    bal, comp = c["balance"], c["compress"]
    ones = torch.ones_like(l)
    shadow_mix = hsl_to_rgb(ones * c["shadow_hue"], ones * c["shadow_sat"], l)
    hl_mix = hsl_to_rgb(ones * c["hl_hue"], ones * c["hl_sat"], l)
    ra_sh = torch.clamp((bal - comp - l) * 2.0, 0.0, 1.0)
    ra_hl = torch.clamp((l - (bal + comp)) * 2.0, 0.0, 1.0)
    out = xc * (1.0 - ra_sh[None]) + shadow_mix * ra_sh[None]
    out = out * (1.0 - ra_hl[None]) + hl_mix * ra_hl[None]
    return torch.clamp(out, 0.0, 1.0)
