"""initialscale — early downscale for reduced-size exports/previews.

Reference: hidden plumbing module `initialscale` in the order tables
(`ansel/src/develop/iop_order.c:117` et al) + the ROI scaling
design (`ansel/doc/resizing-scaling.md`): when the requested
output is smaller than the sensor, the reference propagates a reduced
ROI through the pipe so every module after demosaic processes at the
target resolution instead of full-frame.  Here the same effect is one
explicit resample right after the camera-RGB stage: raw-domain ops
(rawprepare/temperature/highlights/demosaic, which need the CFA grid)
stay full-res, everything downstream runs at export scale — the answer
to "exports at reduced size still process the full frame".

Kernels: the reference's exact set (src/pixel/interpolation.c —
bilinear / bicubic Catmull-Rom -0.5 / Mitchell-Netravali, default
Mitchell) as one dense matrix per axis (pixel/resample.py).  Copied
from `ansel_tpu/ops/initialscale.py`; the products are plain torch.
"""

from __future__ import annotations

import dataclasses

from ..core.params import cfield, params
from ..core.types import ImageSpec
from ..pixel.resample import METHODS, apply_resample, resample_coeffs
from ..pixel.shifts import pad_tail
from .base import Op, OpPlan, PlanContext, register


@params(op="initialscale", version=2)
@dataclasses.dataclass
class InitialScaleParams:
    method: int = cfield("i", 2)  # 0=bilinear, 1=bicubic, 2=mitchell

    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        if version == 1:  # v1: 0=lanczos3, 1=cubic, 2=linear
            (m,) = struct.unpack("<i", raw[:4])
            return cls(method={0: 2, 1: 1, 2: 0}.get(m, 2))
        return None


@register
class InitialScale(Op):
    name = "initialscale"
    input_colorspace = None  # camera RGB, right after demosaic/lens

    def enabled_by_default(self, meta):
        return False  # injected by the planner when downscaling

    def plan(self, ctx: PlanContext, spec_in: ImageSpec, p) -> OpPlan:
        if ctx.scale >= 1.0 - 1e-9:
            return OpPlan(spec_in=spec_in, spec_out=spec_in, static=None)
        w = max(1, int(round(spec_in.width * ctx.scale)))
        h = max(1, int(round(spec_in.height * ctx.scale)))
        spec_out = spec_in.with_size(w, h)
        method = METHODS[p.method] if 0 <= p.method < len(METHODS) \
            else "mitchell"
        return OpPlan(spec_in=spec_in, spec_out=spec_out, static=method)

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p):
        if plan.static is None:
            return {}
        si, so = plan.spec_in, plan.spec_out
        return resample_coeffs(plan.static, si.height, si.width,
                               so.height, so.width)

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        if plan.static is None:
            return x
        si, so = plan.spec_in, plan.spec_out
        v = x[..., : si.height, : si.width]
        out = apply_resample(v, c["rs_mh"], c["rs_mw"])
        return pad_tail(out, so.pad_h - so.height,
                        so.pad_w - so.width).contiguous()
