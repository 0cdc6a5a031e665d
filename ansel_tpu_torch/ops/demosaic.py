"""demosaic — CFA mosaic -> camera RGB.

Reference: `ansel/src/iop/demosaic.c` (params v4 demosaic.c:266-274,
method enum demosaic.c:120-141).  Planning is copied from
`ansel_tpu/ops/demosaic.py`, and so is `apply` with its dispatch
(:180-268).  RCD on a Bayer mosaic (`kernels/rcd.py`) and Markesteijn 1
and 3 passes on X-Trans (`kernels/markesteijn.py`) compute what the TPU
kernels compute.  The JAX package's plain XLA methods are plain torch
here: PPG (what the PREVIEW and THUMBNAIL pipes plan), the bilinear
fallback that every Bayer method the JAX package does not name takes,
AMaZE (`kernels/amaze.py`), LMMSE (`kernels/lmmse.py`), VNG4 and X-Trans
VNG (`kernels/vng.py`), green equilibration before the method and
colour smoothing after it (`kernels/demosaic_post.py`), and the dual
blend: VNG4 (X-Trans VNG) smoothed twice as the low band under the
raw-detail mask of the method's output (`pixel/detail.py`).

As in the JAX package, an X-Trans mosaic turns any method without the
X-Trans flag into MARKESTEIJN (1 pass): bench config 4's 1024 | 2 plans
1 pass, not the 3 its label says.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.params import cfield, params
from ..core.types import CFAPattern, Colorspace, ImageSpec
from . import _bayer
from .base import Op, OpPlan, PlanContext, register

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


def _conv2(x: torch.Tensor, k) -> torch.Tensor:
    """A small 2-D stencil on one plane as shifted adds over an
    edge-padded view, in the JAX function's tap order."""
    from ..pixel.shifts import PaddedView

    kk = [[float(v) for v in row] for row in k]
    r = (len(kk) - 1) // 2
    pv = PaddedView(x, r)
    out = None
    for iy, row in enumerate(kk):
        for ix, t in enumerate(row):
            if t == 0.0:
                continue
            c = t * pv.at(iy - r, ix - r)
            out = c if out is None else out + c
    return out


_K_G = [[0, 1, 0], [1, 4, 1], [0, 1, 0]]
_K_RB = [[1, 2, 1], [2, 4, 2], [1, 2, 1]]


def bilinear_demosaic(x: torch.Tensor, cfa: CFAPattern) -> torch.Tensor:
    """Masked-kernel bilinear: G by its 4-neighbour average, R and B by
    [1 2 1]/4 x [1 2 1]/4 over their sparse planes."""
    h, w = x.shape
    planes = _bayer.color_masks(cfa, h, w, x.device) * x[None]
    return torch.stack([_conv2(planes[0], _K_RB) / 4.0,
                        _conv2(planes[1], _K_G) / 4.0,
                        _conv2(planes[2], _K_RB) / 4.0])


def ppg_demosaic(x: torch.Tensor, cfa: CFAPattern) -> torch.Tensor:
    """Patterned-pixel-grouping as the JAX package computes it: green by
    a gradient-weighted choice of direction, chroma by interpolating the
    colour-minus-green differences.  Its shifts wrap round the frame
    (`jnp.roll`, though its comment says "edge clamp"), and so do these."""
    h, w = x.shape
    masks = _bayer.color_masks(cfa, h, w, x.device)
    is_g = masks[1]

    def sh(a, dy, dx):
        return torch.roll(a, (-dy, -dx), dims=(0, 1))

    gN, gS = sh(x, -1, 0), sh(x, 1, 0)
    gW, gE = sh(x, 0, -1), sh(x, 0, 1)
    cNN, cSS = sh(x, -2, 0), sh(x, 2, 0)
    cWW, cEE = sh(x, 0, -2), sh(x, 0, 2)
    grad_v = torch.abs(gN - gS) + torch.abs(x - cNN) + torch.abs(x - cSS)
    grad_h = torch.abs(gW - gE) + torch.abs(x - cWW) + torch.abs(x - cEE)
    est_v = (gN + gS) * 0.5 + (2.0 * x - cNN - cSS) * 0.25
    est_h = (gW + gE) * 0.5 + (2.0 * x - cWW - cEE) * 0.25
    est_b = (gN + gS + gW + gE) * 0.25 \
        + (4.0 * x - cNN - cSS - cWW - cEE) * 0.125
    g_interp = torch.where(
        grad_v < 0.8 * grad_h, est_v,
        torch.where(grad_h < 0.8 * grad_v, est_h, est_b))
    g = torch.where(is_g > 0, x, torch.clamp(g_interp, min=0.0))

    out = []
    for ci in (0, 2):
        diff = (x - g) * masks[ci]
        num = _conv2(diff, _K_RB)
        den = _conv2(masks[ci], _K_RB)
        out.append(torch.clamp(g + num / torch.clamp(den, min=1e-6),
                               min=0.0))
    return torch.stack([out[0], g, out[1]])


@register
class Demosaic(Op):
    name = "demosaic"
    input_colorspace = Colorspace.RAW
    mandatory = True

    def plan(self, ctx: PlanContext, spec_in: ImageSpec, p: DemosaicParams) -> OpPlan:
        method = p.demosaicing_method
        is_xtrans = spec_in.cfa is CFAPattern.XTRANS
        if is_xtrans and not (method & XTRANS_FLAG):
            method = MARKESTEIJN
        green_eq = 0 if is_xtrans else p.green_eq
        spec_out = spec_in.with_colorspace(Colorspace.CAMERA_RGB)
        return OpPlan(spec_in=spec_in, spec_out=spec_out,
                      static=(method, green_eq,
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
        if (plan.static[0] & ~DUAL_FLAG) == PPG:
            # PPG's shifts wrap round the array (ROADMAP R18): a window
            # that reaches one edge of the frame but not the other would
            # wrap round its own far edge where the whole pipe wraps
            # round the frame's, so it spans that axis instead
            if (y0 == 0) != (y1 == si.height):
                y0, y1 = 0, si.height
            if (x0 == 0) != (x1 == si.width):
                x0, x1 = 0, si.width
        return (y0, x0, y1 - y0, x1 - x0)

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: DemosaicParams):
        # rcd normalizes by max processed_maximum (rcd.c:283-284)
        return {"scaler": max(ctx.processed_maximum)}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        (method_full, green_eq, _median_thrs, smooth, lmmse_refine,
         dual_thrs) = plan.static
        method = method_full & ~DUAL_FLAG
        cfa = plan.spec_in.cfa
        if method in (PASSTHROUGH_MONO, XTRANS_FLAG | PASSTHROUGH_MONO):
            return torch.stack([x, x, x])
        if green_eq:
            from ..kernels import demosaic_post

            # threshold = 0.0001 * ISO (demosaic.c:1001)
            thr = 0.0001 * float(getattr(ctx.meta, "iso", 100.0) or 100.0)
            x = demosaic_post.apply_green_eq(x, cfa, green_eq, thr)
        out = self._demosaic(x, c, method, cfa, ctx, lmmse_refine)
        if (method_full & DUAL_FLAG) and dual_thrs > 0.0:
            out = self._dual(x, out, cfa, ctx, dual_thrs)
        if smooth:
            from ..kernels import demosaic_post

            out = demosaic_post.color_smoothing(out, smooth)
        return out

    def _dual(self, x, out, cfa, ctx, dual_thrs):
        """The dual demosaic (demosaic/dual.c:38-110): VNG4 on Bayer, or
        3-colour VNG on X-Trans (dual.c:66), smoothed twice as the low
        band, under the detail mask of the method's output."""
        from ..kernels import demosaic_post, vng
        from ..pixel import detail

        if cfa is CFAPattern.XTRANS:
            low = vng.xtrans_vng_demosaic(x, ctx.meta.xtrans)
        else:
            low = vng.vng4_demosaic(x, cfa)
        low = demosaic_post.color_smoothing(low, 2)
        contrast = 0.005 * dual_thrs ** 1.1  # slider2contrast
        wb = [max(v, 1e-6) for v in ctx.meta.wb_coeffs[:3]]
        blend = detail.detail_mask(detail.rawdetail_mask(out, wb), contrast,
                                   detail=True)
        return blend[None] * out + (1.0 - blend[None]) * low

    def _demosaic(self, x, c, method, cfa, ctx, lmmse_refine):
        if cfa is CFAPattern.XTRANS:
            if method == XTRANS_FLAG:        # DT_IOP_DEMOSAIC_VNG
                from ..kernels.vng import xtrans_vng_demosaic

                return xtrans_vng_demosaic(x, ctx.meta.xtrans)
            from ..kernels.markesteijn import xtrans_markesteijn

            return xtrans_markesteijn(x, ctx.meta.xtrans,
                                      3 if method == MARKESTEIJN_3 else 1)
        if method == PPG:
            return ppg_demosaic(x, cfa)
        if method == LMMSE:
            from ..kernels.lmmse import lmmse_demosaic

            return lmmse_demosaic(x, cfa, c["scaler"], refine=lmmse_refine)
        if method == VNG4:
            from ..kernels.vng import vng4_demosaic

            return vng4_demosaic(x, cfa)
        if method == AMAZE:
            from ..kernels.amaze import amaze_demosaic

            return amaze_demosaic(x, cfa, c["scaler"])
        if method == RCD:
            from ..kernels.rcd import rcd_demosaic

            return rcd_demosaic(x, cfa, c["scaler"])
        return bilinear_demosaic(x, cfa)
