"""defringe — purple-fringe suppression on Lab chroma edges.

Reference: `ansel/src/iop/defringe.c` — params v1 (:68-73), process
(:~240-420): edge map = squared chroma difference between the image and
its Gaussian blur; pixels above an (average-scaled) threshold (with one
pixel of region growing) get their (a, b) replaced by an
inverse-chroma-weighted neighbourhood average, computed densely with box
means as `ansel_tpu/ops/defringe.py` does; planning and coefficients are
copied from it.  The sigma-4 blur is the sepblur kernel (33 taps);
the box means run it up to radius 7 and cumulative sums above.  In the
global-average mode the mean of the edge map is one torch reduction,
summed in another order than XLA's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.params import cfield, params
from ..core.types import Colorspace
from ..pixel.blur import box_blur, gaussian_blur
from ..pixel.shifts import PaddedView
from .base import Op, OpPlan, PlanContext, register

MODE_GLOBAL_AVERAGE = 0
MODE_LOCAL_AVERAGE = 1
MODE_STATIC = 2
MAGIC = 33.0


@params(op="defringe", version=1)
@dataclasses.dataclass
class DefringeParams:
    radius: float = cfield("f", 4.0)
    thresh: float = cfield("f", 20.0)
    op_mode: int = cfield("i", MODE_GLOBAL_AVERAGE)


@register
class Defringe(Op):
    name = "defringe"
    input_colorspace = Colorspace.LAB

    def plan(self, ctx: PlanContext, spec_in, p: DefringeParams) -> OpPlan:
        sigma = max(0.1, abs(p.radius)) * ctx.scale
        radius = int(math.ceil(2.0 * math.ceil(sigma)))
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(p.op_mode, sigma, max(radius, 3),
                              24 + radius * 4))

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: DefringeParams):
        return {"thresh": np.float32(p.thresh)}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        mode, sigma, small_radius, avg_radius = plan.static
        # only the chroma planes feed the edge detector
        blurred = gaussian_blur(x[1:3], sigma)
        da = x[1] - blurred[0]
        db = x[2] - blurred[1]
        edge = da * da + db * db

        if mode == MODE_GLOBAL_AVERAGE:
            avg = torch.mean(edge) + 1e-6
            thresh = torch.clamp(4.0 * c["thresh"] * avg / MAGIC, min=0.1)
        elif mode == MODE_LOCAL_AVERAGE:
            avg = torch.clamp(box_blur(edge, avg_radius), min=0.01)
            thresh = torch.clamp(4.0 * c["thresh"] * avg / MAGIC, min=0.1)
        else:  # static
            avg = MAGIC
            thresh = torch.clamp(c["thresh"], min=0.1)

        # one pixel of region growing (defringe.c:~365-375): a 3x3 max as
        # two separable passes of shifted views
        pv = PaddedView(edge, 1)
        vmax = torch.maximum(pv.at(-1, 0), torch.maximum(pv.at(0, 0),
                                                         pv.at(1, 0)))
        ph = PaddedView(vmax, 1)
        hit = torch.maximum(ph.at(0, -1), torch.maximum(
            ph.at(0, 0), ph.at(0, 1))) > thresh

        # inverse-chroma-weighted neighbourhood average
        w = 1.0 / (edge + avg)
        norm = torch.clamp(box_blur(w, small_radius), min=1e-12)
        a_new = box_blur(w * x[1], small_radius) / norm
        b_new = box_blur(w * x[2], small_radius) / norm
        return torch.stack([x[0],
                            torch.where(hit, a_new, x[1]),
                            torch.where(hit, b_new, x[2])])
