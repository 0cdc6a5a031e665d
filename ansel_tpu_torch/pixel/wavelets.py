"""A-trous wavelet scales (`ansel_tpu/pixel/wavelets.py`; reference
`src/pixel/eaw.c`): the edge-aware ones and the plain B-spline blur.

Every scale goes to the EAW kernel's wrapper (`kernels/eaw.py`): the CUDA
kernel on the device, its plain twin on the CPU.  Both compute what the
TPU's Pallas kernel computes; the JAX package's XLA path differs from it
by dividing by the weight sum where the kernel multiplies by its inverse.
The sum of squares stays a plain torch reduction, as in the JAX package.
`bspline_blur` (the JAX package's `_sep_blur`) is the sepblur kernel's
dilated B3 blur; `atrous_decompose` and `atrous_reconstruct` (retouch's
wavelet scales) are built on it.
"""

from __future__ import annotations

import torch

from ..kernels import eaw


def eaw_dn_decompose(x: torch.Tensor, scale: int, inv_sigma2):
    """One scale of the denoise edge-aware a-trous decompose (reference
    eaw.c:eaw_dn_decompose + dn_weight :181-195).  x: (3, H, W) ->
    (coarse, detail, sum_sq[3])."""
    coarse, detail = eaw.eaw_dn_coarse(x.contiguous(), scale, inv_sigma2)
    return coarse, detail, torch.sum(detail * detail, dim=(1, 2))


def eaw_synthesize(acc: torch.Tensor, detail: torch.Tensor,
                   thrs) -> torch.Tensor:
    """Soft-threshold shrinkage accumulate (reference eaw.c:157-175)."""
    t = torch.as_tensor(thrs, dtype=detail.dtype,
                        device=detail.device).reshape(-1, 1, 1)
    return acc + (torch.clamp(detail - t, min=0.0)
                  + torch.clamp(detail + t, max=0.0))


def eaw_decompose_scale(x: torch.Tensor, scale: int, sharpen):
    """One scale of the atrous equalizer's edge-aware decompose
    (reference eaw.c eaw_decompose) -> (coarse, detail)."""
    return eaw.eaw_atrous_coarse(x.contiguous(), scale, sharpen)


B3 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def bspline_blur(x: torch.Tensor, scale: int, kernel=B3) -> torch.Tensor:
    """Separable dilated 5-tap B-spline blur on (..., H, W) with hole size
    2^scale (the sepblur kernel on the device)."""
    from .shifts import sep_filter

    return sep_filter(x, kernel, dilation=1 << scale)


def atrous_decompose(x: torch.Tensor, scales: int):
    """-> ([detail_0 .. detail_{s-1}], residual), x = sum(details) +
    residual: the B3 a-trous decompose (reference src/pixel/dwt.c), each
    scale a `bspline_blur` at dilation 2^s."""
    details = []
    cur = x
    for s in range(scales):
        low = bspline_blur(cur, s)
        details.append(cur - low)
        cur = low
    return details, cur


def atrous_reconstruct(details, residual: torch.Tensor,
                       gains=None) -> torch.Tensor:
    """The residual plus each detail layer (times its gain)."""
    out = residual
    for i, d in enumerate(details):
        g = 1.0 if gains is None else gains[i]
        out = out + d * g
    return out
