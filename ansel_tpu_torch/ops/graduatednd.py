"""graduatednd — optical graduated ND filter simulation.

Reference: `ansel/src/iop/graduatednd.c` (params v1 graduatednd.c:87-95;
commit_params, process graduatednd.c:684-760), as
`ansel_tpu/ops/graduatednd.py` has it: a rotated linear gradient
`length`, density 2^(dens * clip(0.5 + length)), out = in / (color +
(1 - color) * density) with the tint from HSL(hue, saturation, 0.5),
mirrored for a negative density.  It reads each pixel's position in its
array (the planned frame's size baked in at plan time), so it is a chain
stage with `needs_pos` and a full-frame boundary of the ROI walk.
"""

from __future__ import annotations

import colorsys
import dataclasses
import math

import torch

from ..color.transforms import fdiv
from ..core.params import cfield, params
from ..kernels.pointwise import OP_GRADUATEDND, positions
from .base import Op, OpPlan, PlanContext, PointwiseSpec, register

_CONSTS = ("density", "sinv", "cosv", "offset", "hardness", "color",
           "color1")


@params(op="graduatednd", version=1)
@dataclasses.dataclass
class GraduatedNDParams:
    density: float = cfield("f", 1.0)
    hardness: float = cfield("f", 0.0)
    rotation: float = cfield("f", 0.0)
    offset: float = cfield("f", 50.0)
    hue: float = cfield("f", 0.0)
    saturation: float = cfield("f", 0.0)


@register
class GraduatedND(Op):
    name = "graduatednd"
    input_colorspace = None  # order 25: runs on scene RGB before colorin

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: GraduatedNDParams):
        r, g, b = colorsys.hls_to_rgb(p.hue, 0.5, p.saturation)
        color = [r, g, b]
        if p.density < 0:
            color = [1.0 - c for c in color]
        color1 = [1.0 - c for c in color]
        v = (-p.rotation / 180.0) * math.pi
        return {
            "density": p.density,
            "sinv": math.sin(v), "cosv": math.cos(v),
            "offset": p.offset / 100.0 * 2.0,
            "hardness": p.hardness / 100.0,
            "color": color, "color1": color1,
        }

    @staticmethod
    def _frame(plan):
        """(half width, half height, 1 / filter radius) of the planned
        frame, as the reference computes them in float64."""
        hw, hh = plan.spec_in.width / 2.0, plan.spec_in.height / 2.0
        return hw, hh, 1.0 / (math.sqrt(hh * hh + hw * hw) / hh)

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        yy, xx = positions(x)
        return _pixel(x, c, xx, yy, self._frame(plan))

    def pointwise_spec(self, plan, ctx):
        frame = self._frame(plan)
        return PointwiseSpec(
            fn=lambda x, c, yy, xx: _pixel(x, c, xx, yy, frame),
            opcode=OP_GRADUATEDND, consts=_CONSTS, extra=frame,
            needs_pos=True)


def _pixel(x, c, xs, ys, frame):
    hw, hh, inv_radius = frame
    hardness = (inv_radius
                / (1.0 - (0.5 + c["hardness"] * 0.9 / 2.0)) * 0.5)
    length = (c["sinv"] * (-1.0 + fdiv(xs, hw))
              - c["cosv"] * (-1.0 + fdiv(ys, hh)) - 1.0 + c["offset"]) \
        * hardness
    dens = c["density"]
    # the reference runs the mirrored formula for negative density
    t = torch.where(dens > 0,
                    torch.clamp(0.5 + length, 0.0, 1.0),
                    torch.clamp(0.5 - length, 0.0, 1.0))
    density = torch.exp2(torch.abs(dens) * t)
    col, col1 = c["color"], c["color1"]
    return torch.stack([
        torch.clamp(x[i] / (col[i] + col1[i] * density), min=0.0)
        for i in range(3)])
