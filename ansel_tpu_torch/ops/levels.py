"""levels — black/gray/white point remap on Lab L.

Reference: `ansel/src/iop/levels.c` (params v2, levels.c:103-110), as
`ansel_tpu/ops/levels.py` has it: L normalised into [levels[0],
levels[2]], the gamma from the gray point, a and b scaled with the L
ratio.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core.params import cfield, params
from ..core.types import Colorspace
from ..kernels.pointwise import OP_LEVELS
from .base import Op, OpPlan, PlanContext, PointwiseSpec, register


@params(op="levels", version=2)
@dataclasses.dataclass
class LevelsParams:
    mode: int = cfield("i", 0)
    black: float = cfield("f", 0.0)
    gray: float = cfield("f", 50.0)
    white: float = cfield("f", 100.0)
    levels: tuple = cfield("3f", (0.0, 0.5, 1.0))


    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        # levels.c v1 {levels[3], levels_preset} -> v2 defaults + levels
        if version == 1:
            l0, l1, l2, _preset = struct.unpack("<3fi", raw[:16])
            return cls(levels=(l0, l1, l2))
        return None


@register
class Levels(Op):
    name = "levels"
    input_colorspace = Colorspace.LAB

    def coeffs(self, ctx, plan, p: LevelsParams):
        lo, mid, hi = p.levels
        hi = max(hi, lo + 1e-4)
        mid_n = min(max((mid - lo) / (hi - lo), 1e-4), 1.0 - 1e-4)
        gamma = math.log(0.5) / math.log(mid_n)
        return {"lo": lo * 100.0, "hi": hi * 100.0, "inv_gamma": 1.0 / gamma}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        return _pixel(x, c)

    def pointwise_spec(self, plan, ctx):
        return PointwiseSpec(fn=_pixel, opcode=OP_LEVELS,
                             consts=("lo", "hi", "inv_gamma"))


def _pixel(x, c):
    L = x[0]
    norm = torch.clamp((L - c["lo"]) / (c["hi"] - c["lo"]), 0.0, 1.0)
    L_out = 100.0 * norm ** c["inv_gamma"]
    ratio = L_out / torch.clamp(L, min=1e-6)
    return torch.stack([L_out, x[1] * ratio, x[2] * ratio])
