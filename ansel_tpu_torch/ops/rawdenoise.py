"""rawdenoise — wavelet denoise on the raw mosaic.

Reference: `ansel/src/iop/rawdenoise.c` (params v2, rawdenoise.c:92-97):
each of the four CFA phase planes is sqrt()-VST'd, decomposed with the
3-tap hat à-trous ([1,2,1]/4 separable, spacing 2^lev;
src/pixel/dwt.c:441-538), each band soft-thresholded with
noise_all[band] * force_all^4 * force_chan^4 * 256 * threshold
(compute_channel_noise rawdenoise.c:199-232), then squared back.
Planning, coefficients and the v1 ladder are copied from
`ansel_tpu/ops/rawdenoise.py`.  The four planes go through each level
as one (4, H/2, W/2) tensor: one sepblur launch a level.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.params import cfield, params
from ..core.types import Colorspace
from ..pixel.shifts import sep_filter
from .base import Op, OpPlan, PlanContext, register

BANDS = 5
CH_ALL, CH_R, CH_G, CH_B = range(4)
NOISE_ALL = (0.8002, 0.2735, 0.1202, 0.0585, 0.0291, 0.0152, 0.0080, 0.0044)


@params(op="rawdenoise", version=2)
@dataclasses.dataclass
class RawDenoiseParams:
    threshold: float = cfield("f", 0.01)
    x: tuple = cfield(f"{4 * BANDS}f", tuple(
        (k / (BANDS - 1.0)) for _ in range(4) for k in range(BANDS)))
    y: tuple = cfield(f"{4 * BANDS}f", (0.5,) * (4 * BANDS))

    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        # rawdenoise.c v1 {threshold} -> default flat force curves
        if version == 1:
            (t,) = struct.unpack("<f", raw[:4])
            return cls(threshold=t)
        return None


def _hat_blur(x: torch.Tensor, lev: int) -> torch.Tensor:
    """separable dilated [1,2,1]/4 (the dwt.c hat transform)."""
    return sep_filter(x, [0.25, 0.5, 0.25], dilation=1 << lev)


def dwt_denoise(img: torch.Tensor, noise) -> torch.Tensor:
    """hat-wavelet soft-threshold denoise (dwt.c:516-538).  `img` is
    (..., H, W); `noise` indexes levels on axis 0 and broadcasts any
    leading axes."""
    accum = torch.zeros_like(img)
    cur = img
    for lev in range(len(noise)):
        smooth = _hat_blur(cur, lev)
        diff = cur - smooth
        t = noise[lev]
        accum = (accum + torch.clamp(diff - t, min=0.0)
                 + torch.clamp(diff + t, max=0.0))
        cur = smooth
    return cur + accum


def _channel_noise(p: RawDenoiseParams, color: int) -> np.ndarray:
    ch = {0: CH_R, 2: CH_B}.get(color, CH_G)
    out = np.zeros(BANDS, np.float32)
    for i in range(BANDS):
        f_ch = p.y[ch * BANDS + (BANDS - i - 1)]
        f_all = p.y[CH_ALL * BANDS + (BANDS - i - 1)]
        out[i] = (NOISE_ALL[i] * (f_all**4) * (f_ch**4) * 256.0
                  * p.threshold)
    return out


@register
class RawDenoise(Op):
    name = "rawdenoise"
    input_colorspace = Colorspace.RAW
    # hat wavelet on half-res CFA planes: sum(1*2^l, l<BANDS) = 31 plane
    # rows = 62 mosaic rows of stencil support
    window_halo = 2 * ((1 << BANDS) - 1)

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: RawDenoiseParams):
        cfa = plan.spec_in.cfa
        noise = np.zeros((2, 2, BANDS), np.float32)
        for y in range(2):
            for x in range(2):
                noise[y, x] = _channel_noise(p, cfa.color_at(y, x))
        return {"noise": noise}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        h, w = x.shape
        # the 4 CFA phase planes, VST'd, denoised in one batched pass
        planes = x.reshape(h // 2, 2, w // 2, 2).permute(1, 3, 0, 2) \
                  .reshape(4, h // 2, w // 2)
        vst = torch.sqrt(torch.clamp(planes, min=0.0)).contiguous()
        # noise: (2, 2, BANDS) -> (BANDS, 4, 1, 1) to broadcast per level
        nz = c["noise"].reshape(4, -1).T[:, :, None, None]
        den = dwt_denoise(vst, nz)
        out = den * den
        return out.reshape(2, 2, h // 2, w // 2).permute(2, 0, 3, 1) \
                  .reshape(h, w)
