"""Blurs (`ansel_tpu/pixel/blur.py`; reference `src/pixel/box_filters.c`,
`src/pixel/gaussian.c`): box means, the Deriche recursive Gaussian and
the Gaussians built on them (`gaussian_blur`: the separable FIR for
sigma <= 4, the IIR beyond; `gaussian_blur_fast`: block mean, IIR,
bilinear upsample; `fast_gaussian`: three box means).

`gaussian_iir` always goes to the IIR kernel's wrapper (`kernels/iir.py`):
the CUDA kernel on the device, its plain twin on the CPU.  The JAX
package's XLA block forms of the recursion (`_iir_pass`,
`_iir_axis_dual`, `blocked_cumsum`) are TPU formulations and are not
ported; on the TPU big planes take the Pallas kernel, which the port
follows everywhere.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import iir
from .bilateralgrid import upsample_axis
from .shifts import pad_tail, sep_filter


def box_blur_1d(x: torch.Tensor, radius: int, axis: int) -> torch.Tensor:
    """Mean over a (2r+1) window via a cumulative sum of the edge-padded
    axis: O(1) per pixel at any radius."""
    if radius <= 0:
        return x
    axis = axis % x.dim()
    n = x.shape[axis]
    moved = x.movedim(axis, -1)
    lead = moved.shape[:-1]
    flat = moved.reshape(-1, 1, n)
    xp = F.pad(flat, (radius + 1, radius), mode="replicate")
    cs = torch.cumsum(xp, dim=-1)
    out = (cs[..., 2 * radius + 1:2 * radius + 1 + n] - cs[..., :n]) \
        / (2 * radius + 1)
    return out.reshape(tuple(lead) + (n,)).movedim(-1, axis)


def box_blur(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Box mean over (2r+1)^2: small windows through the separable FIR,
    larger ones through cumulative sums."""
    if radius <= 0:
        return x
    if radius <= 7 and x.dim() >= 2:
        n = 2 * radius + 1
        return sep_filter(x, [1.0 / n] * n)
    return box_blur_1d(box_blur_1d(x, radius, -2), radius, -1)


def _deriche_coeffs(sigma: float, order: int = 0):
    """compute_gauss_params (src/pixel/gaussian.c:44-96), in float64."""
    alpha = 1.695 / sigma
    ema = math.exp(-alpha)
    ema2 = math.exp(-2.0 * alpha)
    b1, b2 = -2.0 * ema, ema2
    if order == 1:
        a0 = (1.0 - ema) ** 2
        a1, a2, a3 = 0.0, -a0, 0.0
    elif order == 2:
        k = -(ema2 - 1.0) / (2.0 * alpha * ema)
        kn = -2.0 * (-1.0 + 3.0 * ema - 3.0 * ema * ema + ema ** 3)
        kn /= 3.0 * ema + 1.0 + 3.0 * ema * ema + ema ** 3
        a0 = kn
        a1 = -kn * (1.0 + k * alpha) * ema
        a2 = kn * (1.0 - k * alpha) * ema
        a3 = -kn * ema2
    else:
        k = (1.0 - ema) ** 2 / (1.0 + 2.0 * alpha * ema - ema2)
        a0 = k
        a1 = k * (alpha - 1.0) * ema
        a2 = k * (alpha + 1.0) * ema
        a3 = -k * ema2
    coefp = (a0 + a1) / (1.0 + b1 + b2)
    coefn = (a2 + a3) / (1.0 + b1 + b2)
    return a0, a1, a2, a3, b1, b2, coefp, coefn


def gaussian_iir(x: torch.Tensor, sigma: float, order: int = 0,
                 vmin: float = None, vmax: float = None) -> torch.Tensor:
    """Deriche recursive Gaussian of an (..., H, W) tensor, the mirror of
    dt_gaussian_blur (src/pixel/gaussian.c:150-320) with its boundary
    priming, as the TPU's Pallas kernel computes it."""
    if sigma <= 0:
        return x
    return iir.gaussian_iir(x.contiguous(), _deriche_coeffs(sigma, order),
                            vmin, vmax)


def gaussian_blur(x: torch.Tensor, sigma: float,
                  truncate: float = 4.0) -> torch.Tensor:
    """Separable FIR Gaussian (the sepblur kernel) for sigma <= 4, the
    Deriche IIR beyond."""
    if sigma <= 0:
        return x
    if sigma > 4.0:
        return gaussian_iir(x, sigma)
    r = max(1, int(math.ceil(truncate * sigma)))
    t = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (t / sigma) ** 2)
    k /= k.sum()
    return sep_filter(x, [float(v) for v in k])


def gaussian_blur_fast(x: torch.Tensor, sigma: float,
                       max_ds: int = 8) -> torch.Tensor:
    """Large-sigma Gaussian: a ds x ds block mean, the IIR Gaussian at
    sigma / ds (the block mean's variance taken out), then the
    cell-centred bilinear upsample back (`bilateralgrid.upsample_axis`).
    Below sigma 16, `gaussian_blur`."""
    if sigma < 16.0:
        return gaussian_blur(x, sigma)
    ds = int(min(max_ds, sigma // 8))
    H, W = x.shape[-2:]
    Hp, Wp = -(-H // ds) * ds, -(-W // ds) * ds
    xp = pad_tail(x, Hp - H, Wp - W)
    lead = tuple(xp.shape[:-2])
    small = xp.reshape(lead + (Hp // ds, ds, Wp // ds, ds)).mean(dim=(-3, -1))
    sig_ds = math.sqrt(max(sigma * sigma - ds * ds / 12.0, 1e-6)) / ds
    small = gaussian_blur(small.contiguous(), sig_ds)
    out = upsample_axis(upsample_axis(small, ds, axis=-2), ds, axis=-1)
    return out[..., :H, :W]


def fast_gaussian(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Three iterated box means approximating a Gaussian of `sigma` (the
    ideal box width for three passes), at a cost independent of it."""
    if sigma <= 0:
        return x
    wi = math.sqrt(4.0 * sigma * sigma / 3.0 + 1.0)
    r = max(1, int((wi - 1) / 2))
    y = x
    for _ in range(3):
        y = box_blur(y, r)
    return y
