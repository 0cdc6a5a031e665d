"""scalepixels — non-square sensor pixel aspect correction.

Reference: `ansel/src/iop/scalepixels.c` — params v1 (:51-57): aspect < 1
stretches vertically, > 1 horizontally.  As in
`ansel_tpu/ops/scalepixels.py`, a `jax.image.resize(..., "lanczos3")` of
the valid region, which the port computes with the same weight matrices
(`pixel/resample.resize_lanczos3`), in plain torch.
"""

from __future__ import annotations

import dataclasses

from ..core.params import cfield, params
from ..pixel.resample import resize_lanczos3
from ..pixel.shifts import pad_tail
from .base import Op, OpPlan, PlanContext, register


@params(op="scalepixels", version=1)
@dataclasses.dataclass
class ScalePixelsParams:
    pixel_aspect_ratio: float = cfield("f", 1.0)


@register
class ScalePixels(Op):
    name = "scalepixels"
    input_colorspace = None  # geometric, any RGB

    def enabled_by_default(self, meta):
        return False

    def plan(self, ctx: PlanContext, spec_in,
             p: ScalePixelsParams) -> OpPlan:
        par = p.pixel_aspect_ratio
        h, w = spec_in.height, spec_in.width
        if par <= 0 or abs(par - 1.0) < 1e-6:
            return OpPlan(spec_in=spec_in, spec_out=spec_in, static=None)
        if par < 1.0:
            h = int(round(h / par))  # stretch vertically
        else:
            w = int(round(w * par))
        spec_out = dataclasses.replace(spec_in, height=h, width=w,
                                       pad_w=0, pad_h=0)
        return OpPlan(spec_in=spec_in, spec_out=spec_out, static=(h, w))

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        if plan.static is None:
            return x
        spec = plan.spec_out
        out = resize_lanczos3(
            x[:, : plan.spec_in.height, : plan.spec_in.width],
            (x.shape[0], spec.height, spec.width))
        return pad_tail(out, spec.array_shape[-2] - spec.height,
                        spec.array_shape[-1] - spec.width).contiguous()
