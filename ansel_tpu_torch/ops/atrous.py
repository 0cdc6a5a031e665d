"""atrous — edge-aware a-trous wavelet "contrast equalizer".

Reference: `ansel/src/iop/atrous.c` (params v2 atrous.c:123-129; band
math get_scales atrous.c:255-296), as `ansel_tpu/ops/atrous.py` has it:
per-scale Lab decompose with photometric edge weights (src/pixel/eaw.c),
band boosts (2 curve_L)^2 / (2 curve_c)^2, noise thresholds
2^(-7(1 - t)) {10, 20} curve_t, edge sharpen 0.0025 curve_s; soft
threshold and boost synthesis.  Each scale is one launch of the EAW
kernel's atrous variant (`pixel/wavelets.eaw_decompose_scale`).  The
planner keeps each scale's sharpen in `plan.aux` as well, so the
kernel's argument is a host float; `plan.static` is the reference's, the
scale count.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.params import cfield, params
from ..core.types import Colorspace
from ..pixel.curves import CATMULL_ROM, sample_curve
from ..pixel.wavelets import eaw_decompose_scale
from .base import Op, OpPlan, PlanContext, full_dims, register

BANDS = 6
MAX_NUM_SCALES = 7
CH_L, CH_C, CH_S, CH_LT, CH_CT, CH_NONE = range(6)

_DEFAULT_XY = []
for _c in range(5):
    _DEFAULT_XY.append([k / (BANDS - 1.0) for k in range(BANDS)])  # x
_DEFAULT_Y = [[0.5] * BANDS, [0.5] * BANDS, [0.5] * BANDS,
              [0.0] * BANDS, [0.0] * BANDS]


@params(op="atrous", version=2)
@dataclasses.dataclass
class AtrousParams:
    octaves: int = cfield("i", 3)
    x: tuple = cfield(f"{5 * BANDS}f",
                      tuple(v for row in _DEFAULT_XY for v in row))
    y: tuple = cfield(f"{5 * BANDS}f",
                      tuple(v for row in _DEFAULT_Y for v in row))
    mix: float = cfield("f", 1.0)

    @classmethod
    def from_legacy(cls, version, raw):
        if version == 1:
            # atrous.c legacy_params: v1 = {octaves, x, y} without mix
            p = cls.codec.decode(raw + b"\0" * 4)
            p.mix = 1.0
            return p
        return None


def _curve_value(p: AtrousParams, ch: int, t: float) -> float:
    xs = list(p.x[ch * BANDS : (ch + 1) * BANDS])
    ys = list(p.y[ch * BANDS : (ch + 1) * BANDS])
    if p.mix != 1.0:
        dx = _DEFAULT_XY[ch]
        dy = _DEFAULT_Y[ch]
        xs = [min(1.0, max(0.0, x + (p.mix - 1.0) * (x - dxv)))
              for x, dxv in zip(xs, dx)]
        ys = [min(1.0, max(0.0, y + (p.mix - 1.0) * (y - dyv)))
              for y, dyv in zip(ys, dy)]
    lut = sample_curve(xs, ys, CATMULL_ROM, lut_max=1.0, size=256)
    tt = min(max(t, 0.0), 1.0)
    return float(lut[int(round(tt * 255))])


def _bands(p: AtrousParams, spec_in, scale: float):
    """Per scale (boost_l, boost_c, thrs_l, thrs_c, sharp), up to the
    first scale past the frame's largest feature (t < 0)."""
    fh, fw = full_dims(spec_in)  # piece dims (window-safe)
    supp0 = min(2 * (2 << (MAX_NUM_SCALES - 1)) + 1, max(fw, fh) * 0.2)
    i0 = math.log2(max((supp0 - 1.0) * 0.5, 1.0))
    bands = []
    for i in range(MAX_NUM_SCALES):
        supp = 2 * (2 << i) + 1
        supp_in = supp / max(scale, 1e-6)
        i_in = math.log2((supp_in - 1) * 0.5) - 1.0
        t = 1.0 - (i_in + 0.5) / max(i0, 1e-6)
        boost_l = (2.0 * _curve_value(p, CH_L, t)) ** 2
        boost_c = (2.0 * _curve_value(p, CH_C, t)) ** 2
        thrs_l = 2.0 ** (-7.0 * (1.0 - t)) * 10.0 * _curve_value(p, CH_LT, t)
        thrs_c = 2.0 ** (-7.0 * (1.0 - t)) * 20.0 * _curve_value(p, CH_CT, t)
        sharp = 0.0025 * _curve_value(p, CH_S, t)
        bands.append((boost_l, boost_c, thrs_l, thrs_c, sharp))
        if t < 0.0:
            break
    return bands


@register
class Atrous(Op):
    name = "atrous"
    input_colorspace = Colorspace.LAB

    def plan(self, ctx: PlanContext, spec_in, p: AtrousParams) -> OpPlan:
        bands = _bands(p, spec_in, ctx.scale)
        fh, fw = full_dims(spec_in)
        max_scale_roi = int(math.floor(math.log2(min(fw, fh)))) - 2
        n = min(max_scale_roi, len(bands))
        return OpPlan(spec_in=spec_in, spec_out=spec_in, static=n,
                      aux=tuple(float(np.float32(b[4])) for b in bands[:n]))

    def roi_in(self, plan: OpPlan, ctx: PlanContext, win):
        """The a-trous B3 stencil: spacing-2^s supports compound to
        2 (2^n - 1) rows and columns."""
        si, so = plan.spec_in, plan.spec_out
        if tuple(win) == (0, 0, so.height, so.width):
            return (0, 0, si.height, si.width)
        halo = 2 * ((1 << plan.static) - 1)
        y0 = max(0, win[0] - halo)
        x0 = max(0, win[1] - halo)
        y1 = min(si.height, win[0] + win[2] + halo)
        x1 = min(si.width, win[1] + win[3] + halo)
        return (y0, x0, y1 - y0, x1 - x0)

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: AtrousParams):
        n = plan.static
        bands = _bands(p, plan.spec_in, ctx.scale)
        boost = np.zeros((n, 3), np.float32)
        thrs = np.zeros((n, 3), np.float32)
        sharp = np.zeros(n, np.float32)
        for i in range(n):
            bl, bc, tl, tc, sh = bands[i]
            boost[i] = (bl, bc, bc)
            thrs[i] = (tl, tc, tc)
            sharp[i] = sh
        return {"boost": boost, "thrs": thrs, "sharp": sharp}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        out = torch.zeros_like(x)
        cur = x
        for s, sharp in enumerate(plan.aux):
            low, detail = eaw_decompose_scale(cur, s, sharp)
            t = c["thrs"][s].reshape(3, 1, 1)
            b = c["boost"][s].reshape(3, 1, 1)
            amount = (torch.clamp(detail - t, min=0.0)
                      + torch.clamp(detail + t, max=0.0))
            out = out + b * amount
            cur = low
        return out + cur
