"""demosaic — CFA mosaic -> camera RGB.

Reference: `ansel/src/iop/demosaic.c` (params v4 demosaic.c:266-274,
method enum demosaic.c:120-141).  Planning is copied from
`ansel_tpu/ops/demosaic.py`.  Only RCD on a Bayer mosaic is ported, and it
computes what the TPU kernel computes (`kernels/rcd.py`); every other
method, X-Trans, green equilibration, colour smoothing and the dual
blend raise at plan time.
"""

from __future__ import annotations

import dataclasses

from ..core.params import cfield, params
from ..core.types import CFAPattern, Colorspace, ImageSpec
from .base import Op, OpPlan, PlanContext, not_ported, register

# method ids (reference demosaic.c:120-141)
PPG = 0
AMAZE = 1
VNG4 = 2
PASSTHROUGH_MONO = 3
PASSTHROUGH_COLOR = 4
RCD = 5
LMMSE = 6
DOWNSAMPLE = 7
XTRANS_FLAG = 0x1000   # DEMOSAIC_XTRANS
DUAL_FLAG = 0x2000     # DEMOSAIC_DUAL
MARKESTEIJN = XTRANS_FLAG | 1
MARKESTEIJN_3 = XTRANS_FLAG | 2


@params(op="demosaic", version=4)
@dataclasses.dataclass
class DemosaicParams:
    green_eq: int = cfield("i", 0)
    median_thrs: float = cfield("f", 0.0)
    color_smoothing: int = cfield("i", 0)
    demosaicing_method: int = cfield("i", RCD)
    lmmse_refine: int = cfield("i", 1)
    dual_thrs: float = cfield("f", 0.20)

    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        if version == 3:  # demosaic.c:342-359: dual_thrs added in v4
            g, m, cs, dm, lr = struct.unpack("<ifiIi", raw[:20])
            return cls(green_eq=g, median_thrs=m, color_smoothing=cs,
                       demosaicing_method=dm, lmmse_refine=lr)
        return None


@register
class Demosaic(Op):
    name = "demosaic"
    input_colorspace = Colorspace.RAW
    mandatory = True

    def plan(self, ctx: PlanContext, spec_in: ImageSpec, p: DemosaicParams) -> OpPlan:
        if spec_in.cfa is CFAPattern.XTRANS:
            raise not_ported(self.name, "the X-Trans mosaic")
        method = p.demosaicing_method
        if method != RCD:
            raise not_ported(self.name, f"method {method} (only RCD = {RCD})")
        for field in ("green_eq", "color_smoothing"):
            if getattr(p, field):
                raise not_ported(self.name, field)
        spec_out = spec_in.with_colorspace(Colorspace.CAMERA_RGB)
        return OpPlan(spec_in=spec_in, spec_out=spec_out,
                      static=(method, p.green_eq,
                              round(float(p.median_thrs), 6),
                              int(p.color_smoothing),
                              int(p.lmmse_refine),
                              round(float(p.dual_thrs), 4)))

    def roi_in(self, plan: OpPlan, ctx: PlanContext, win):
        """Windowed demosaic: grow by the interpolation support and snap
        the origin to the 6-row/col CFA super-period."""
        si, so = plan.spec_in, plan.spec_out
        if tuple(win) == (0, 0, so.height, so.width):
            return (0, 0, si.height, si.width)
        halo = 18
        y0 = max(0, win[0] - halo) // 6 * 6
        x0 = max(0, win[1] - halo) // 6 * 6
        y1 = min(si.height, win[0] + win[2] + halo)
        x1 = min(si.width, win[1] + win[3] + halo)
        return (y0, x0, y1 - y0, x1 - x0)

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: DemosaicParams):
        # rcd normalizes by max processed_maximum (rcd.c:283-284)
        return {"scaler": max(ctx.processed_maximum)}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        from ..kernels.rcd import rcd_demosaic

        return rcd_demosaic(x, plan.spec_in.cfa, c["scaler"])
