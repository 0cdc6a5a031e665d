"""Fast local Laplacian filter (`ansel_tpu/pixel/locallaplacian.py`).

Reference: `src/pixel/locallaplacian.c` (Paris/Hasinoff/Kautz with
num_gamma = 6 remap samples, locallaplacian.c:48,282-470): a Gaussian
pyramid of the input, 6 curve-remapped pyramids (curve_scalar,
locallaplacian.c:295-326), each level's Laplacian interpolated between
the two bracketing gammas, then collapsed.  Every 5-tap blur goes through
`pixel/shifts.sep_filter`, the sepblur kernel on the device.  The JAX
package's `lax.scan` over the gammas is a Python loop that keeps one
gamma pyramid live.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .shifts import sep_filter

NUM_GAMMA = 6
_K5 = [float(v) for v in np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32)
       / 16.0]


def _reduce(x: torch.Tensor) -> torch.Tensor:
    return sep_filter(x, _K5)[..., ::2, ::2]


def _expand(x: torch.Tensor, shape) -> torch.Tensor:
    h, w = shape
    x = x[..., : (h + 1) // 2, : (w + 1) // 2]
    h2, w2 = x.shape[-2:]
    up = x.new_zeros(tuple(x.shape[:-2]) + (2 * h2, 2 * w2))
    up[..., ::2, ::2] = x
    return sep_filter(up[..., :h, :w], _K5) * 4.0


def curve(x, g, sigma, shadows, highlights, clarity):
    """curve_scalar (locallaplacian.c:295-326), elementwise.  `g` is a
    float32 value; g + sigma and g - sigma round in float32, as the JAX
    package's traced scalar does."""
    g_hi = float(np.float32(g) + np.float32(sigma))
    g_lo = float(np.float32(g) - np.float32(sigma))
    c = x - g
    t_s = torch.clamp(c / (2.0 * sigma), 0.0, 1.0)
    t_h = torch.clamp(-c / (2.0 * sigma), 0.0, 1.0)
    val_shadow = g + sigma * 2.0 * (1.0 - t_s) * t_s \
        + t_s * t_s * (sigma + sigma * shadows)
    val_highlight = g - sigma * 2.0 * (1.0 - t_h) * t_h \
        + t_h * t_h * (-sigma - sigma * highlights)
    val = torch.where(c > 2.0 * sigma, g_hi + shadows * (c - sigma),
                      torch.where(c < -2.0 * sigma,
                                  g_lo + highlights * (c + sigma),
                                  torch.where(c > 0.0, val_shadow,
                                              val_highlight)))
    return val + clarity * c * torch.exp(-c * c / (2.0 * sigma * sigma / 3.0))


def local_laplacian(L: torch.Tensor, sigma: float, shadows: float,
                    highlights: float, clarity: float) -> torch.Tensor:
    """(H, W) luminance in [0, 1] -> filtered; the pyramid depth follows
    the image size (down to ~4 px, at most 10 levels)."""
    h, w = L.shape
    n_levels = max(2, min(10, int(math.log2(max(min(h, w), 4))) - 1))

    gpyr = [L]
    for _ in range(n_levels - 1):
        gpyr.append(_reduce(gpyr[-1]))

    step = 1.0 / NUM_GAMMA
    # hat weights per level, from the input pyramid
    idxs = [torch.clamp((g - 0.5 * step) / step, 0.0, NUM_GAMMA - 1.0)
            for g in gpyr[:-1]]
    accs = [torch.zeros_like(g) for g in gpyr[:-1]]
    for k in range(NUM_GAMMA):
        # the gamma as the float32 the JAX package's scan carries
        g = float(np.float32((k + 0.5) / NUM_GAMMA))
        pyr = [curve(L, g, sigma, shadows, highlights, clarity)]
        for _ in range(n_levels - 1):
            pyr.append(_reduce(pyr[-1]))
        for lvl in range(n_levels - 1):
            lap = pyr[lvl] - _expand(pyr[lvl + 1], pyr[lvl].shape)
            wk = torch.clamp(1.0 - torch.abs(idxs[lvl] - float(k)), min=0.0)
            accs[lvl] = accs[lvl] + wk * lap

    # collapse: the coarsest Gaussian level plus each level's Laplacian
    out = gpyr[-1]
    for lvl in range(n_levels - 2, -1, -1):
        out = _expand(out, gpyr[lvl].shape) + accs[lvl]
    return out
