"""shadhi — shadows & highlights recovery.

Reference: `ansel/src/iop/shadhi.c` (params v5, shadhi.c:148-162;
process: a Gaussian or bilateral blur of the Lab image, then an
inverted-L overlay in up to 4 chunked passes for each of highlights and
shadows, with compress-windowed opacity and chroma correction).
Planning, the v1-v4 ladder and the per-pixel arithmetic are copied from
`ansel_tpu/ops/shadhi.py`; the bilateral algorithm is the L-guided grid
(`pixel/bilateralgrid.grid_filter`), the Gaussian one
`pixel/blur.gaussian_blur_fast`.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core.params import cfield, params
from ..core.types import Colorspace
from ..pixel.bilateralgrid import grid_filter
from ..pixel.blur import gaussian_blur_fast
from .base import Op, OpPlan, PlanContext, register


@params(op="shadhi", version=5)
@dataclasses.dataclass
class ShadHiParams:
    order: int = cfield("i", 0)
    radius: float = cfield("f", 100.0)
    shadows: float = cfield("f", 50.0)
    whitepoint: float = cfield("f", 0.0)
    highlights: float = cfield("f", -50.0)
    reserved2: float = cfield("f", 0.0)
    compress: float = cfield("f", 50.0)
    shadows_ccorrect: float = cfield("f", 100.0)
    highlights_ccorrect: float = cfield("f", 50.0)
    flags: int = cfield("I", 0)
    low_approximation: float = cfield("f", 0.000001)
    shadhi_algo: int = cfield("i", 0)

    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        # shadhi.c version ladder (:222-320); algo from radius sign
        if version == 1:
            o, r, sh, res1, hi, res2, comp = struct.unpack("<i6f",
                                                           raw[:28])
            return cls(order=o, radius=abs(r), shadows=0.5 * sh,
                       whitepoint=res1, reserved2=res2,
                       highlights=-0.5 * hi, compress=comp,
                       shadows_ccorrect=100.0, highlights_ccorrect=0.0,
                       flags=0, low_approximation=0.01,
                       shadhi_algo=1 if r < 0.0 else 0)
        if version in (2, 3, 4):
            fmt = {2: "<i8f", 3: "<i8fI", 4: "<i8fIf"}[version]
            sz = {2: 36, 3: 40, 4: 44}[version]
            v = struct.unpack(fmt, raw[:sz])
            flags = v[9] if version >= 3 else 0
            low = v[10] if version == 4 else 0.01
            return cls(order=v[0], radius=abs(v[1]), shadows=v[2],
                       whitepoint=v[3], highlights=v[4],
                       reserved2=v[5], compress=v[6],
                       shadows_ccorrect=v[7], highlights_ccorrect=v[8],
                       flags=flags, low_approximation=low,
                       shadhi_algo=1 if v[1] < 0.0 else 0)
        return None


def _sign(v):
    return 1.0 if v > 0 else (-1.0 if v < 0 else 0.0)


@register
class ShadowsHighlights(Op):
    name = "shadhi"
    input_colorspace = Colorspace.LAB

    def plan(self, ctx: PlanContext, spec_in, p: ShadHiParams) -> OpPlan:
        sigma = max(0.1, abs(p.radius)) * ctx.scale
        bilat = p.shadhi_algo == 1 or p.radius < 0.0
        # all tone params gate control flow (pass counts, signs) -> static
        shadows = 2.0 * min(max(p.shadows / 100.0, -1.0), 1.0)
        highlights = 2.0 * min(max(p.highlights / 100.0, -1.0), 1.0)
        static = (
            round(sigma, 3), round(shadows, 5), round(highlights, 5),
            round(max(1.0 - p.whitepoint / 100.0, 0.01), 5),
            round(min(max(p.compress / 100.0, 0.0), 0.99), 5),
            round((min(max(p.shadows_ccorrect / 100.0, 0.0), 1.0) - 0.5)
                  * _sign(shadows) + 0.5, 5),
            round((min(max(p.highlights_ccorrect / 100.0, 0.0), 1.0) - 0.5)
                  * _sign(-highlights) + 0.5, 5),
            max(p.low_approximation, 1e-6),
            bilat,
        )
        return OpPlan(spec_in=spec_in, spec_out=spec_in, static=static)

    def coeffs(self, ctx, plan, p: ShadHiParams):
        return None

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        (sigma, shadows_v, highlights_v, whitepoint, compress,
         shadows_cc, highlights_cc, low, bilat) = plan.static
        if bilat:
            # SHADHI_ALGO_BILATERAL (shadhi.c:345-360): L-guided grid
            blurred = grid_filter(x[0], x, max(sigma, 1.0), 100.0,
                                  0.0, 100.0)
        else:
            blurred = gaussian_blur_fast(x, sigma)
        # scale to unit Lab (ta = in / 100, tb = inverted blur L)
        ta_L = x[0] / 100.0
        ta_a = x[1] / 128.0
        ta_b = x[2] / 128.0
        tb_L = (100.0 - blurred[0]) / 100.0
        wp = torch.full((), whitepoint, dtype=x.dtype, device=x.device)
        ta_L = torch.where(ta_L > 0, ta_L / wp, ta_L)
        tb_L = torch.where(tb_L > 0, tb_L / wp, tb_L)

        def overlay_passes(taL, taA, taB, amount, xform, ccorrect, hl):
            amt2 = amount * amount
            s = _sign(-amount) if hl else _sign(amount)
            n_pass = int(math.ceil(max(amt2, 1e-9)))
            for k in range(min(n_pass, 4)):
                chunk = min(max(amt2 - k, 0.0), 1.0)
                la = torch.clamp(taL, 0.0, 1.0)
                lb = torch.clamp((tb_L - 0.5) * s * torch.sign(1.0 - la)
                                 + 0.5, 0.0, 1.0)
                lref = torch.sign(la) / torch.clamp(torch.abs(la), min=low)
                href = torch.sign(1.0 - la) / torch.clamp(
                    torch.abs(1.0 - la), min=low)
                optrans = chunk * xform
                newL = la * (1.0 - optrans) + torch.where(
                    la > 0.5,
                    1.0 - (1.0 - 2.0 * (la - 0.5)) * (1.0 - lb),
                    2.0 * la * lb) * optrans
                newL = torch.clamp(newL, 0.0, 1.0)
                if hl:
                    cf = newL * lref * (1.0 - ccorrect) \
                        + (1.0 - newL) * href * ccorrect
                else:
                    cf = newL * lref * ccorrect \
                        + (1.0 - newL) * href * (1.0 - ccorrect)
                taA = torch.clamp(taA * (1.0 - optrans)
                                  + (taA + 0.0) * cf * optrans, -1.0, 1.0)
                taB = torch.clamp(taB * (1.0 - optrans)
                                  + (taB + 0.0) * cf * optrans, -1.0, 1.0)
                taL = newL
            return taL, taA, taB

        hl_xform = torch.clamp(1.0 - tb_L / (1.0 - compress), 0.0, 1.0)
        ta_L, ta_a, ta_b = overlay_passes(ta_L, ta_a, ta_b, highlights_v,
                                          hl_xform, highlights_cc, hl=True)
        sh_xform = torch.clamp(tb_L / (1.0 - compress)
                               - compress / (1.0 - compress), 0.0, 1.0)
        ta_L, ta_a, ta_b = overlay_passes(ta_L, ta_a, ta_b, shadows_v,
                                          sh_xform, shadows_cc, hl=False)
        return torch.stack([ta_L * 100.0, ta_a * 128.0, ta_b * 128.0])
