"""monochrome — black and white through a virtual colour filter.

Reference: `ansel/src/iop/monochrome.c` (params v2, monochrome.c:84-90):
L_out = 100 * filter(a, b), a Gaussian chroma filter centred at
(p.a, p.b) of width p.size * 128, smoothed (the reference uses a
bilateral grid; `ansel_tpu/ops/monochrome.py` a wide three-box Gaussian,
`pixel/blur.fast_gaussian`, which the port follows), then a
highlight-weighted blend with the original L.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.params import cfield, params
from ..core.types import Colorspace
from ..pixel.blur import fast_gaussian
from .base import Op, OpPlan, PlanContext, register


@params(op="monochrome", version=2)
@dataclasses.dataclass
class MonochromeParams:
    a: float = cfield("f", 0.0)
    b: float = cfield("f", 0.0)
    size: float = cfield("f", 2.0)
    highlights: float = cfield("f", 0.0)

    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        # monochrome.c v1 = v2 minus trailing highlights (set to 0)
        if version == 1:
            a, b, size = struct.unpack("<3f", raw[:12])
            return cls(a=a, b=b, size=size, highlights=0.0)
        return None


def _color_filter(a, b, fa, fb, sigma2):
    return torch.exp(-torch.clamp(((a - fa) ** 2 + (b - fb) ** 2)
                                  / (2.0 * sigma2), 0.0, 30.0))


@register
class Monochrome(Op):
    name = "monochrome"
    input_colorspace = Colorspace.LAB

    def coeffs(self, ctx, plan, p):
        return {"a": p.a, "b": p.b,
                "sigma2": (p.size * 128.0) ** 2,
                "highlights": p.highlights}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        filt = 100.0 * _color_filter(x[1], x[2], c["a"], c["b"], c["sigma2"])
        filt = fast_gaussian(filt, 20.0 / max(ctx.scale, 1e-3))
        tt = c["highlights"]
        L = x[0]
        tmpL = torch.clamp(L * filt / 100.0, 0.0, 100.0)
        out_L = torch.clamp((1.0 - tt) * tmpL + tt * L, 0.0, 100.0)
        z = torch.zeros_like(L)
        return torch.stack([out_L, z, z])
