"""Raw-detail mask: Scharr gradient magnitude -> sigmoid -> 9x9 blur
(`ansel_tpu/pixel/detail.py`).

Reference: `src/develop/masks/detail.c` (dt_masks_calc_rawdetail_mask
:283-315: sqrt-gamma luminance and Scharr; calcBlendFactor :317-323;
dt_masks_calc_detail_mask :325-335; dt_masks_blur_9x9_coeff :159-196, a
disc-truncated Gaussian of sigma 2).  The blend details slider reads it
(develop/blend.c:381).
"""

from __future__ import annotations

import numpy as np
import torch

from ..color.transforms import fdiv
from .shifts import PaddedView

# how far from a pixel the demosaiced image decides its detail mask: 1
# for the Scharr gradient, 4 for the 9x9 blur
MASK_REACH = 5


def _blur_9x9_kernel(sigma: float = 2.0) -> np.ndarray:
    k = np.zeros((9, 9), np.float32)
    rng = (3.0 * 1.5) ** 2
    for dy in range(-4, 5):
        for dx in range(-4, 5):
            r2 = dy * dy + dx * dx
            if r2 <= rng:
                k[dy + 4, dx + 4] = np.exp(r2 / (-2.0 * sigma * sigma))
    return k / k.sum()


def blur_9x9(x: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """The disc-truncated 9x9 Gaussian, edge-padded, its taps summed in
    row-major order, clipped to [0, 1]."""
    k = _blur_9x9_kernel(sigma)
    p = PaddedView(x, 4)
    out = None
    for dy in range(-4, 5):
        for dx in range(-4, 5):
            w = float(k[dy + 4, dx + 4])
            if w == 0.0:
                continue
            t = w * p.at(dy, dx)
            out = t if out is None else out + t
    return torch.clamp(out, 0.0, 1.0)


def rawdetail_mask(rgb: torch.Tensor, wb=(1.0, 1.0, 1.0)) -> torch.Tensor:
    """(3, H, W) demosaiced camera RGB -> (H, W) Scharr gradient plane
    (detail.c:283-315)."""
    val = fdiv(fdiv(torch.clamp(rgb[0], min=0.0), wb[0])
               + fdiv(torch.clamp(rgb[1], min=0.0), wb[1])
               + fdiv(torch.clamp(rgb[2], min=0.0), wb[2]), 3.0)
    t = torch.sqrt(val)  # sqrt gamma: the noise variance uniform
    p = PaddedView(t, 1)
    gx = (47.0 * (p.at(-1, -1) - p.at(-1, 1))
          + 162.0 * (p.at(0, -1) - p.at(0, 1))
          + 47.0 * (p.at(1, -1) - p.at(1, 1)))
    gy = (47.0 * (p.at(-1, -1) - p.at(1, -1))
          + 162.0 * (p.at(-1, 0) - p.at(1, 0))
          + 47.0 * (p.at(-1, 1) - p.at(1, 1)))
    gx = gx / 256.0
    gy = gy / 256.0
    return torch.sqrt(gx * gx + gy * gy) / 16.0


def detail_mask(raw_mask: torch.Tensor, threshold: float,
                detail: bool = True) -> torch.Tensor:
    """The sigmoid blend factor and the 9x9 blur (detail.c:317-335)."""
    blend = fdiv(1.0, 1.0 + torch.exp(16.0 - (16.0 / threshold) * raw_mask))
    if not detail:
        blend = 1.0 - blend
    return blur_9x9(blend, 2.0)
