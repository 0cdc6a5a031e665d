"""temperature — white balance channel multipliers on the mosaic.

Reference: `ansel/src/iop/temperature.c` — params {red, green, blue, g2}
(temperature.c:117-123); commit maps them to per-color coeffs with a
NaN-g2 fallback to green, process multiplies each CFA site by its color's
coefficient and scales processed_maximum by the coeffs.  Planning is
copied from `ansel_tpu/ops/temperature.py`; X-Trans mosaics raise at
plan time.
"""

from __future__ import annotations

import dataclasses
import math

from ..core.params import cfield, params
from ..core.types import CFAPattern, Colorspace, ImageSpec, RawMeta
from . import _bayer
from .base import Op, OpPlan, PlanContext, not_ported, register


@params(op="temperature", version=3)
@dataclasses.dataclass
class TemperatureParams:
    red: float = cfield("f", 1.0)
    green: float = cfield("f", 1.0)
    blue: float = cfield("f", 1.0)
    g2: float = cfield("f", float("nan"))

    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        # temperature.c legacy v2 {temp_out, coeffs[3]} -> v3 (g2 = NaN)
        if version == 2:
            _t, r, g, b = struct.unpack("<4f", raw[:16])
            return cls(red=r, green=g, blue=b, g2=float("nan"))
        return None


@register
class Temperature(Op):
    name = "temperature"
    input_colorspace = Colorspace.RAW
    # per-CFA-position multiply; windows stay CFA-phase aligned
    window_halo = 0
    mandatory = True

    def default_params(self, meta: RawMeta):
        r, g, b, g2 = meta.wb_coeffs
        # as-shot coefficients normalized to green=1 (reference reload_defaults)
        if g > 0:
            r, b, g2 = r / g, b / g, (g2 / g if g2 else 0.0)
            g = 1.0
        return TemperatureParams(red=r, green=g, blue=b,
                                 g2=g2 if g2 else float("nan"))

    def _commit(self, p: TemperatureParams):
        g2 = p.g2
        # NaN/denormal g2 poisons half the green sites -> fall back to green
        # (reference temperature.c commit_params g2_usable check)
        if not (isinstance(g2, float) and math.isfinite(g2) and g2 > 1e-12):
            g2 = p.green
        return [p.red, p.green, p.blue, g2]

    def plan(self, ctx: PlanContext, spec_in: ImageSpec, p) -> OpPlan:
        if spec_in.cfa is CFAPattern.XTRANS:
            raise not_ported(self.name, "the X-Trans mosaic")
        coeffs = self._commit(p)
        pm = ctx.processed_maximum
        ctx.processed_maximum = tuple(pm[i] * coeffs[i] for i in range(3))
        ctx.wb_coeffs = tuple(coeffs)
        return OpPlan(spec_in=spec_in, spec_out=spec_in)

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p):
        return {"coeffs": self._commit(p)}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        spec = plan.spec_in
        return x * _bayer.color_select(c["coeffs"], spec.cfa, spec.pad_h,
                                       spec.pad_w, device=x.device)
