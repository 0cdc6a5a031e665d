"""nlmeans — "denoise (non-local means)" Lab denoiser.

Reference: `ansel/src/iop/nlmeans.c` (params v2, nlmeans.c:81-88;
process_cpu nlmeans.c:416-456): patch radius P = ceil(radius*scale),
search K = ceil(7*scale), sharpness = 3000/(1+strength), Lab-normalized
SSD (L/120, C/512), result blended per channel by luma/chroma amounts.
Planning, `roi_in`, coefficients and the v1 ladder are copied from
`ansel_tpu/ops/nlmeans.py`.  The patch average is `pixel/nlmeans.nlmeans`
with the iop weighting: the NLM kernel, variant 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.params import cfield, params
from ..core.types import Colorspace
from ..pixel.nlmeans import nlmeans
from .base import Op, OpPlan, PlanContext, register

_NL, _NC = 1.0 / 120.0, 1.0 / 512.0
NORM = [_NL * _NL, _NC * _NC, _NC * _NC]
# the weights as the kernel takes them (float32 launch parameters): the
# coefficient entry rounded as `coeffs_to_device` rounds it, read on the
# host so the device holds no value the launch must wait for
_NORM32 = [float(np.float32(v)) for v in NORM]


@params(op="nlmeans", version=2)
@dataclasses.dataclass
class NLMeansParams:
    radius: float = cfield("f", 2.0)
    strength: float = cfield("f", 50.0)
    luma: float = cfield("f", 0.5)
    chroma: float = cfield("f", 1.0)

    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        # nlmeans.c v1 {luma, chroma} -> radius 3, strength 100
        if version == 1:
            luma, chroma = struct.unpack("<2f", raw[:8])
            return cls(radius=3.0, strength=100.0, luma=luma,
                       chroma=chroma)
        return None


@register
class NLMeans(Op):
    name = "nlmeans"
    input_colorspace = Colorspace.LAB

    def plan(self, ctx: PlanContext, spec_in, p: NLMeansParams) -> OpPlan:
        scale = min(ctx.scale, 2.0)
        P = max(0, int(-(-p.radius * scale // 1)))
        K = int(-(-7 * scale // 1))
        # fast pipes skip every other search patch (nlmeans.c:440)
        decimate = ctx.notes.get("pipe_type") in ("preview", "thumbnail")
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(P, K, decimate))

    def roi_in(self, plan: OpPlan, ctx: PlanContext, win):
        """Finite stencil: patch radius + search radius."""
        si, so = plan.spec_in, plan.spec_out
        if tuple(win) == (0, 0, so.height, so.width):
            return (0, 0, si.height, si.width)
        P, K, _dec = plan.static
        halo = P + K
        y0 = max(0, win[0] - halo)
        x0 = max(0, win[1] - halo)
        y1 = min(si.height, win[0] + win[2] + halo)
        x1 = min(si.width, win[1] + win[3] + halo)
        return (y0, x0, y1 - y0, x1 - x0)

    def coeffs(self, ctx, plan, p):
        return {"sharpness": 3000.0 / (1.0 + p.strength),
                "norm": list(NORM),
                "luma": max(p.luma, 1e-4), "chroma": max(p.chroma, 1e-4)}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        P, K, decimate = plan.static
        den = nlmeans(x, P, K, c["sharpness"], _NORM32,
                      center_weight=-1.0, decimate=decimate)
        w = torch.stack([c["luma"], c["chroma"], c["chroma"]]) \
            .to(x.dtype).reshape(3, 1, 1)
        return x * (1.0 - w) + den * w
