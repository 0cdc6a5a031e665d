"""tonemap — Durand 2002 dynamic-range compression.

Reference: `ansel/src/iop/tonemap.cc` (params v1 :82-86): log luminance
split into a base and a detail layer, the base compressed by 1/contrast.
As in `ansel_tpu/ops/tonemap.py`, whose planning and coefficients are
copied here, the edge-aware base is a guided filter on log L
(`pixel/guided.guided_filter`, radius at most 256) where the reference
runs a permutohedral lattice.  Runs on camera RGB before colorin.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.params import cfield, params
from ..pixel.guided import guided_filter
from .base import Op, OpPlan, PlanContext, register


@params(op="tonemap", version=1)
@dataclasses.dataclass
class TonemapParams:
    contrast: float = cfield("f", 2.5)
    Fsize: float = cfield("f", 30.0)


@register
class Tonemap(Op):
    name = "tonemap"
    input_colorspace = None  # pre-colorin: camera RGB

    def plan(self, ctx: PlanContext, spec_in, p: TonemapParams) -> OpPlan:
        sigma_s = max(int((p.Fsize / 100.0)
                          * min(spec_in.width, spec_in.height)), 3)
        # the guided filter's radius, capped
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(min(sigma_s, 256),))

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: TonemapParams):
        return {"contr": np.float32(1.0 / max(p.contrast, 1e-6))}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        (radius,) = plan.static
        L = 0.2126 * x[0] + 0.7152 * x[1] + 0.0722 * x[2]
        logL = torch.log(torch.clamp(L, min=1e-6))
        # sigma_r = 0.4 in the reference lattice; eps = sigma_r^2
        B = guided_filter(logL, logL, radius, 0.16)
        detail = logL - B
        Ln = torch.exp(B * (c["contr"] - 1.0) + detail - 1.0)
        return x * Ln[None]
