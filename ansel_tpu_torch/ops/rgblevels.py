"""rgblevels — black/gray/white remap in RGB, linked or per channel.

Reference: `ansel/src/iop/rgblevels.c` (params v1, rgblevels.c:79-84), as
`ansel_tpu/ops/rgblevels.py` has it: the levels gamma math in work RGB,
with the preserve-colors norm in linked mode.  The chain stage's ints
are the autoscale mode and the norm.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..color import matrices as cm
from ..core.params import cfield, params
from ..core.types import Colorspace
from ..kernels.pointwise import OP_RGBLEVELS
from .base import Op, OpPlan, PlanContext, PointwiseSpec, register
from .rgbcurve import rgb_norm

LINKED, INDEPENDENT = 1, 0


@params(op="rgblevels", version=1)
@dataclasses.dataclass
class RGBLevelsParams:
    autoscale: int = cfield("i", LINKED)
    preserve_colors: int = cfield("i", 1)
    levels: tuple = cfield("9f", (0.0, 0.5, 1.0) * 3)


def _chan(p, i):
    lo, mid, hi = p.levels[3 * i : 3 * i + 3]
    hi = max(hi, lo + 1e-4)
    mid_n = min(max((mid - lo) / (hi - lo), 1e-4), 1.0 - 1e-4)
    gamma = math.log(0.5) / math.log(mid_n)
    return lo, hi, 1.0 / gamma


@register
class RGBLevels(Op):
    name = "rgblevels"
    input_colorspace = Colorspace.WORK_RGB

    def plan(self, ctx: PlanContext, spec_in, p) -> OpPlan:
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(p.autoscale, p.preserve_colors))

    def coeffs(self, ctx, plan, p: RGBLevelsParams):
        chans = [_chan(p, i) for i in range(3)]
        return {"lo": np.float32([c[0] for c in chans]),
                "hi": np.float32([c[1] for c in chans]),
                "ig": np.float32([c[2] for c in chans]),
                "y_weights": np.float32(cm.WORK_Y)}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        return _pixel(x, c, plan.static)

    def pointwise_spec(self, plan, ctx):
        static = plan.static
        return PointwiseSpec(fn=lambda x, c: _pixel(x, c, static),
                             opcode=OP_RGBLEVELS,
                             consts=("lo", "hi", "ig", "y_weights"),
                             ints=tuple(static))


def _remap(v, lo, hi, ig):
    return torch.clamp((v - lo) / (hi - lo), 0.0, 1.0) ** ig


def _pixel(x, c, static):
    autoscale, preserve = static
    lo, hi, ig = c["lo"], c["hi"], c["ig"]
    if autoscale == LINKED and preserve != 0:
        n = torch.clamp(rgb_norm(x, preserve, c["y_weights"]), min=1e-6)
        mapped = _remap(n, lo[0], hi[0], ig[0])
        return x * (mapped / n)[None]
    if autoscale == LINKED:
        return _remap(x, lo[0], hi[0], ig[0])
    return torch.stack([_remap(x[i], lo[i], hi[i], ig[i])
                        for i in range(3)])
