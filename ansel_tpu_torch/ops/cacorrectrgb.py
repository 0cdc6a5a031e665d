"""cacorrectrgb — chromatic aberration correction after demosaic.

Reference: `ansel/src/iop/cacorrectrgb.c` — params (:156-163),
manifolds (get_manifolds + normalize_manifolds): split pixels into
above/below-local-average sets of the guide channel, blur (guide, log2
channel ratios, weight) per set, normalize; correction
(apply_correction :523-580): log-position weights between the two
manifolds, corrected channel = guide * ratio_low^wl * ratio_high^wh with
standard/darken/brighten modes; artifact safety blend
(reduce_artifacts :583-640): w = exp(-|log2 blur(out)/blur(in)| * safety).
sigma = radius/scale, safety = 20^(1-strength).  Planning and
coefficients are copied from `ansel_tpu/ops/cacorrectrgb.py`.  The
blurs are `pixel/blur.gaussian_blur`: at the default sigma of 5 the
Deriche IIR kernel, seven launches an image.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.params import cfield, params
from ..pixel.blur import gaussian_blur
from .base import Op, OpPlan, PlanContext, register

GUIDE_R, GUIDE_G, GUIDE_B = 0, 1, 2
MODE_STANDARD, MODE_DARKEN, MODE_BRIGHTEN = 0, 1, 2
MAX_EV_DIFF = 2.0


@params(op="cacorrectrgb", version=1)
@dataclasses.dataclass
class CACorrectRGBParams:
    guide_channel: int = cfield("i", GUIDE_G)
    radius: float = cfield("f", 5.0)
    strength: float = cfield("f", 0.5)
    mode: int = cfield("i", MODE_STANDARD)
    refine_manifolds: int = cfield("i", 0)


@register
class CACorrectRGB(Op):
    name = "cacorrectrgb"
    input_colorspace = None  # camera RGB, right after demosaic (order 13.5)

    def plan(self, ctx: PlanContext, spec_in, p: CACorrectRGBParams) -> OpPlan:
        sigma = max(p.radius / max(ctx.scale, 1e-6), 1.0)
        if p.refine_manifolds:
            sigma = max(p.radius * p.radius / max(ctx.scale, 1e-6), 1.0)
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(p.guide_channel, p.mode, min(sigma, 256.0)))

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: CACorrectRGBParams):
        return {"safety": np.float32(20.0 ** (1.0 - p.strength))}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        guide, mode, sigma = plan.static
        others = [(guide + 1) % 3, (guide + 2) % 3]
        pixg = torch.clamp(x[guide], min=1e-6)
        blurred_g = gaussian_blur(pixg, sigma)

        wh = (pixg >= blurred_g).to(x.dtype)
        wl = (pixg <= blurred_g).to(x.dtype)
        logd = [torch.log2(torch.clamp(x[ch], min=1e-6) / pixg)
                for ch in others]
        maxlog = torch.maximum(torch.abs(logd[0]), torch.abs(logd[1]))
        cw = torch.where(maxlog > MAX_EV_DIFF, MAX_EV_DIFF
                         / torch.clamp(maxlog, min=1e-6), 1.0)
        wh = wh * cw
        wl = wl * cw

        # blur (guide*w, logdiff*w, w) per manifold, then normalize
        def manifold(w):
            stack = torch.stack([pixg * w, logd[0] * w, logd[1] * w, w])
            b = gaussian_blur(stack, sigma)
            wgt = torch.clamp(b[3], min=1e-2)
            # clamp before deriving the channel manifolds: a blur can
            # ring epsilon-negative, and a negative base into the
            # fractional pow below is NaN
            g = torch.clamp(b[0] / wgt, min=1e-6)
            return g, torch.exp2(b[1] / wgt) * g, torch.exp2(b[2] / wgt) * g

        high_g, high_c0, high_c1 = manifold(wh)
        low_g, low_c0, low_c1 = manifold(wl)

        # apply_correction (cacorrectrgb.c:523-580)
        hg = torch.clamp(high_g, min=1e-6)
        lg = torch.clamp(low_g, min=1e-6)
        log_high, log_low = torch.log2(hg), torch.log2(lg)
        dist = log_high - log_low
        log_pix = torch.log2(torch.minimum(torch.maximum(pixg, lg), hg))
        w_low = torch.abs(log_high - log_pix) / torch.clamp(dist, min=1e-6)
        thr = 0.25
        soft = torch.clamp(dist / thr, 0.0, 1.0)
        w_low = torch.where(dist < thr, w_low * soft + 0.5 * (1.0 - soft),
                            w_low)
        # inverted manifolds (hg < lg, possible in flat noise) would give
        # a negative exponent and 1e-9**-x = inf
        w_low = torch.clamp(w_low, 0.0, 1.0)
        w_high = torch.clamp(1.0 - w_low, min=0.0)

        out = [None, None, None]
        out[guide] = pixg
        for ch, hc, lc in [(others[0], high_c0, low_c0),
                           (others[1], high_c1, low_c1)]:
            ratio = ((torch.clamp(lc / lg, min=1e-9) ** w_low)
                     * (torch.clamp(hc / hg, min=1e-9) ** w_high))
            corr = pixg * ratio
            pixel = torch.clamp(x[ch], min=0.0)
            if mode == MODE_DARKEN:
                corr = torch.minimum(corr, pixel)
            elif mode == MODE_BRIGHTEN:
                corr = torch.maximum(corr, pixel)
            out[ch] = corr
        y = torch.stack(out)

        # artifact safety blend (reduce_artifacts :583-640)
        safety = c["safety"]
        w = torch.ones_like(pixg)
        for ch in others:
            avg_in = torch.log2(torch.clamp(gaussian_blur(
                torch.clamp(x[ch], min=0.0), sigma), min=1e-6))
            avg_out = torch.log2(torch.clamp(gaussian_blur(
                torch.clamp(y[ch], min=0.0), sigma), min=1e-6))
            w = w * torch.exp(-torch.clamp(torch.abs(avg_out - avg_in),
                                           min=0.01) * safety)
        res = [None, None, None]
        res[guide] = pixg
        for ch in others:
            res[ch] = (1.0 - w) * torch.clamp(x[ch], min=0.0) \
                + w * torch.clamp(y[ch], min=0.0)
        return torch.stack(res)
