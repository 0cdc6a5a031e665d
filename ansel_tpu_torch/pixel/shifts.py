"""Shifted-view stencils (`ansel_tpu/pixel/shifts.py`).

`PaddedView` pads an (..., H, W) tensor once and serves shifted views as
slices.  `sep_filter` is the edge-padded dilated separable FIR: it hands
every tensor to the sepblur wrapper (`kernels/sepblur.py`), which runs
the kernel on the card at every size (the JAX package's 1 MP floor and
8-plane cap are TPU tiling matters) and runs the plain shifted adds for a
CPU tensor.  The kernel takes (C, H, W) or (H, W); a tensor of more axes
has its leading axes folded into C and back, so every rank the JAX
package's `sep_filter` takes runs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_TORCH_MODE = {"edge": "replicate", "reflect": "reflect"}


def pad2d(x: torch.Tensor, margin: int, mode: str = "edge") -> torch.Tensor:
    """Pad the last two axes of `x` by `margin` (numpy's "edge" or
    "reflect")."""
    if margin == 0:
        return x
    lead = x.shape[:-2]
    flat = x.reshape((-1,) + tuple(x.shape[-2:]))
    p = F.pad(flat, (margin,) * 4, mode=_TORCH_MODE[mode])
    return p.reshape(tuple(lead) + tuple(p.shape[-2:]))


def pad_tail(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Edge-pad the last two axes of `x` by `ph` rows below and `pw`
    columns to the right."""
    if ph == 0 and pw == 0:
        return x
    lead = x.shape[:-2]
    flat = x.reshape((-1, 1) + tuple(x.shape[-2:]))
    p = F.pad(flat, (0, pw, 0, ph), mode="replicate")
    return p.reshape(tuple(lead) + tuple(p.shape[-2:]))


class PaddedView:
    """Pad an (..., H, W) tensor once by `margin` and serve shifted views:
    at(dy, dx)[..., y, x] = padded x[..., y + dy, x + dx]."""

    def __init__(self, x: torch.Tensor, margin: int, mode: str = "edge"):
        self.h, self.w = x.shape[-2:]
        self.margin = margin
        self.p = pad2d(x, margin, mode)

    def at(self, dy: int, dx: int) -> torch.Tensor:
        m = self.margin
        return self.p[..., m + dy: m + dy + self.h,
                      m + dx: m + dx + self.w]


def sep_filter(x: torch.Tensor, taps, dilation: int = 1) -> torch.Tensor:
    """Separable odd-length FIR at spacing `dilation` over the last two
    axes of (..., H, W), edge-padded: the vertical pass, then the
    horizontal pass, each summed in tap order.  The blur is per plane, so
    folding the leading axes of a tensor of more than three into one
    changes no value."""
    from ..kernels import sepblur

    x = x.contiguous()
    if x.dim() <= 3:
        return sepblur.sep_blur(x, taps, dilation)
    planes = x.reshape((-1,) + tuple(x.shape[-2:]))
    return sepblur.sep_blur(planes, taps, dilation).reshape(x.shape)
