"""colorreconstruct — recover colour in blown highlights from the
unclipped pixels around them.

Reference: `ansel/src/iop/colorreconstruction.c` — params v3 (:99-106),
a bilateral-grid splat of (L, a, b) from unclipped pixels with optional
chroma or hue precedence, sliced back into clipped pixels with
blend = clip(20 / threshold * L - 19) and chroma scaled by L / L_est
(:518-574).  As in `ansel_tpu/ops/colorreconstruct.py`, the grid is a
two-scale spatially weighted mean: large Gaussians
(`pixel/blur.gaussian_blur_fast`) of (w, w L, w a, w b), the tighter
scale wherever it has coverage.  Planning and coefficients are copied.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.params import cfield, params
from ..core.types import Colorspace
from ..pixel.blur import gaussian_blur_fast
from .base import Op, OpPlan, PlanContext, register

PRECEDENCE_NONE = 0
PRECEDENCE_CHROMA = 1
PRECEDENCE_HUE = 2


@params(op="colorreconstruct", version=3)
@dataclasses.dataclass
class ColorReconstructParams:
    threshold: float = cfield("f", 100.0)
    spatial: float = cfield("f", 400.0)
    range_ext: float = cfield("f", 10.0)
    hue: float = cfield("f", 0.66)
    precedence: int = cfield("i", PRECEDENCE_NONE)

    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        # colorreconstruction.c v1/v2 -> hue 0.66 default
        if version == 1:
            t, s, r = struct.unpack("<3f", raw[:12])
            return cls(threshold=t, spatial=s, range_ext=r,
                       precedence=0, hue=0.66)
        if version == 2:
            t, s, r, p = struct.unpack("<3fi", raw[:16])
            return cls(threshold=t, spatial=s, range_ext=r,
                       precedence=p, hue=0.66)
        return None


@register
class ColorReconstruct(Op):
    name = "colorreconstruct"
    input_colorspace = Colorspace.LAB

    def plan(self, ctx: PlanContext, spec_in, p: ColorReconstructParams):
        sigma = max(p.spatial * ctx.scale, 4.0)
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(p.precedence, min(sigma, 256.0)))

    def coeffs(self, ctx: PlanContext, plan: OpPlan,
               p: ColorReconstructParams):
        return {
            "threshold": np.float32(p.threshold),
            "hue_cos": np.float32(math.cos(2.0 * math.pi * p.hue)),
            "hue_sin": np.float32(math.sin(2.0 * math.pi * p.hue)),
        }

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        precedence, sigma = plan.static
        L, a, b = x[0], x[1], x[2]
        thr = c["threshold"]
        w = (L < thr).to(x.dtype)
        if precedence == PRECEDENCE_CHROMA:
            w = w * (a * a + b * b)
        elif precedence == PRECEDENCE_HUE:
            chroma = torch.sqrt(a * a + b * b)
            inv = torch.where(chroma > 0,
                              1.0 / torch.clamp(chroma, min=1e-9),
                              torch.zeros_like(chroma))
            # weight by closeness to the preferred hue
            sim = (a * inv * c["hue_cos"] + b * inv * c["hue_sin"]
                   + 1.0) / 2.0
            w = w * sim * sim

        est = []
        for s in (sigma / 4.0, sigma):
            dd = gaussian_blur_fast(w, s) + 1e-9
            est.append([gaussian_blur_fast(w * L, s) / dd,
                        gaussian_blur_fast(w * a, s) / dd,
                        gaussian_blur_fast(w * b, s) / dd,
                        dd])
        # prefer the tighter scale where it has coverage
        cover = est[0][3] > 1e-4
        Le, ae, be, weight = (torch.where(cover, t, u)
                              for t, u in zip(est[0], est[1]))

        blend = torch.clamp(20.0 / thr * L - 19.0, 0.0, 1.0)
        ratio = L / torch.clamp(torch.abs(Le), min=1e-6)
        valid = weight > 1e-6
        a_out = torch.where(valid, a * (1.0 - blend) + ae * ratio * blend, a)
        b_out = torch.where(valid, b * (1.0 - blend) + be * ratio * blend, b)
        return torch.stack([L, a_out, b_out])
