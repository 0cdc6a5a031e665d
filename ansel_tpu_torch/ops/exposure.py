"""exposure — scene-referred gain + black level correction.

Reference: `ansel/src/iop/exposure.c` — params v6 (exposure.c:114-122);
scale = 1 / (2^-exposure - black) (exposure2white macro exposure.c:92,
_process_common_setup exposure.c:431-468); process: out = (in - black) *
scale; processed_maximum *= scale (commit_params exposure.c:630).
Planning is copied from `ansel_tpu/ops/exposure.py`.
"""

from __future__ import annotations

import dataclasses

from ..core.params import cfield, params
from ..core.types import ImageSpec
from ..kernels.pointwise import OP_EXPOSURE
from .base import Op, OpPlan, PlanContext, PointwiseSpec, register

EXPOSURE_MODE_MANUAL = 0
EXPOSURE_MODE_DEFLICKER = 1


@params(op="exposure", version=6)
@dataclasses.dataclass
class ExposureParams:
    mode: int = cfield("i", EXPOSURE_MODE_MANUAL)
    black: float = cfield("f", 0.0)
    exposure: float = cfield("f", 0.0)
    deflicker_percentile: float = cfield("f", 50.0)
    deflicker_target_level: float = cfield("f", -4.0)
    compensate_exposure_bias: int = cfield("i", 0)

    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        if version == 2:  # exposure.c:209-230: {black, exposure, gain}
            black, exposure, _gain = struct.unpack("<3f", raw[:12])
            return cls(black=black, exposure=exposure)
        if version in (3, 4, 5):
            # v3+: same leading fields as v6 minus trailing additions
            vals = struct.unpack("<iffff", raw[:20])
            return cls(mode=vals[0], black=vals[1], exposure=vals[2],
                       deflicker_percentile=vals[3],
                       deflicker_target_level=vals[4])
        return None


@register
class Exposure(Op):
    name = "exposure"
    input_colorspace = None  # works on mosaic or RGB identically

    def _scale(self, ctx: PlanContext, p: ExposureParams):
        exposure = p.exposure
        if p.compensate_exposure_bias:
            exposure -= ctx.meta.exposure_bias
        white = 2.0 ** (-exposure)
        return 1.0 / (white - p.black)

    def plan(self, ctx: PlanContext, spec_in: ImageSpec, p) -> OpPlan:
        s = self._scale(ctx, p)
        ctx.processed_maximum = tuple(m * s for m in ctx.processed_maximum)
        return OpPlan(spec_in=spec_in, spec_out=spec_in)

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p):
        return {"black": p.black, "scale": self._scale(ctx, p)}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        return _exposure(x, c)

    def pointwise_spec(self, plan, ctx):
        return PointwiseSpec(fn=_exposure, opcode=OP_EXPOSURE,
                             consts=("black", "scale"))


def _exposure(x, c):
    return (x - c["black"]) * c["scale"]
