"""bilateral — "surface blur / denoise (bilateral filter)".

Reference: `ansel/src/iop/bilateral.cc` (params :60-66, process
:171-214): a 5-D permutohedral-lattice bilateral over (x, y, R, G, B)
with spatial sigma = radius (scaled by the ROI scale) and per-channel
range sigmas.  As in `ansel_tpu/ops/bilateral.py`, each channel runs its
own bilateral grid guided by itself (`pixel/bilateralgrid.grid_filter`,
range [0, 2]): the channelwise approximation the JAX package documents.
Planning is copied from it.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.params import cfield, params
from ..pixel.bilateralgrid import grid_filter
from .base import Op, OpPlan, PlanContext, register


@params(op="bilateral", version=1)
@dataclasses.dataclass
class BilateralParams:
    radius: float = cfield("f", 15.0)
    reserved: float = cfield("f", 15.0)
    red: float = cfield("f", 0.005)
    green: float = cfield("f", 0.005)
    blue: float = cfield("f", 0.005)


@register
class Bilateral(Op):
    name = "bilateral"
    # sits right after demosaic in the iop order (camera RGB); the filter
    # is colorspace-agnostic like the reference's IOP_CS_RGB contract
    input_colorspace = None

    def enabled_by_default(self, meta):
        return False

    def plan(self, ctx: PlanContext, spec_in, p: BilateralParams) -> OpPlan:
        sigma_s = max(p.radius * ctx.scale, 1.0)
        sigmas = (max(p.red, 1e-4), max(p.green, 1e-4), max(p.blue, 1e-4))
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(round(sigma_s, 4), sigmas))

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        sigma_s, sigmas = plan.static
        # the grid's range-bin count is capped at 32, so tiny sigmas act
        # as sigma_r = range / 31 of the [0, 2] domain
        return torch.stack([
            grid_filter(x[ch], x[ch:ch + 1], sigma_s, sr, 0.0, 2.0)[0]
            for ch, sr in enumerate(sigmas)])
