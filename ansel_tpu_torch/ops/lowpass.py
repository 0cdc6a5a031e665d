"""lowpass — Gaussian or bilateral low-pass with contrast, brightness and
saturation.

Reference: `ansel/src/iop/lowpass.c` (params v4, lowpass.c:110-119):
blur the Lab image (Gaussian by default; the bilateral algorithm is the
L-guided grid, `pixel/bilateralgrid.grid_filter`), then L through
contrast (slope around 50) and brightness (gamma), a/b scaled by
saturation.  Planning, coefficients and the v1-v3 ladder are copied from
`ansel_tpu/ops/lowpass.py`.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.params import cfield, params
from ..core.types import Colorspace
from ..pixel.bilateralgrid import grid_filter
from ..pixel.blur import gaussian_blur_fast
from .base import Op, OpPlan, PlanContext, register


@params(op="lowpass", version=4)
@dataclasses.dataclass
class LowpassParams:
    order: int = cfield("i", 0)
    radius: float = cfield("f", 10.0)
    contrast: float = cfield("f", 1.0)
    brightness: float = cfield("f", 0.0)
    saturation: float = cfield("f", 1.0)
    lowpass_algo: int = cfield("i", 0)
    unbound: int = cfield("i", 1)

    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        # lowpass.c version ladder; algo from radius sign
        if version in (1, 2, 3):
            if version == 1:   # {order, radius, contrast, saturation}
                o, r, con, sat = struct.unpack("<i3f", raw[:16])
                bri, unb = 0.0, 0
            elif version == 2:  # + brightness
                o, r, con, bri, sat = struct.unpack("<i4f", raw[:20])
                unb = 0
            else:               # + unbound
                o, r, con, bri, sat, unb = struct.unpack("<i4fi",
                                                         raw[:24])
            return cls(order=o, radius=abs(r), contrast=con,
                       brightness=bri, saturation=sat,
                       lowpass_algo=1 if r < 0.0 else 0, unbound=unb)
        return None


@register
class Lowpass(Op):
    name = "lowpass"
    input_colorspace = Colorspace.LAB

    def plan(self, ctx: PlanContext, spec_in, p: LowpassParams) -> OpPlan:
        sigma = max(0.1, abs(p.radius)) * ctx.scale
        bilat = p.lowpass_algo == 1 or p.radius < 0.0
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(round(sigma, 3), bool(p.unbound), bilat))

    def coeffs(self, ctx, plan, p):
        return {"contrast": p.contrast, "brightness": p.brightness,
                "saturation": p.saturation}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        sigma, unbound, bilat = plan.static
        if bilat:
            # LOWPASS_ALGO_BILATERAL: L-guided grid, sigma_r = 100
            # (lowpass.c:362-372)
            y = grid_filter(x[0], x, max(sigma, 1.0), 100.0, 0.0, 100.0)
        else:
            y = gaussian_blur_fast(x, sigma)
        # negative contrast mirrors the curve (reference ctable semantics)
        L = 50.0 + (y[0] - 50.0) * c["contrast"]
        # brightness as gamma on normalized L (reference ltable)
        gamma = 2.0 ** (-c["brightness"])
        L = 100.0 * torch.clamp(L / 100.0, min=0.0) ** gamma
        a = y[1] * c["saturation"]
        b = y[2] * c["saturation"]
        if not unbound:
            L = torch.clamp(L, 0.0, 100.0)
            a = torch.clamp(a, -128.0, 128.0)
            b = torch.clamp(b, -128.0, 128.0)
        return torch.stack([L, a, b])
