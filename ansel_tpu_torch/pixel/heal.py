"""Poisson heal (seamless clone) as `ansel_tpu/pixel/heal.py` solves it.

Reference: `src/pixel/heal.c`: solve the Laplace equation for the
(destination - source) difference inside the mask, with the unmasked
difference as its boundary, then add the source back (dt_heal /
_heal_laplace_loop :314-380).  The JAX package relaxes it by Jacobi
steps, 96 on each of three levels from coarse to fine (each level
seeded by the coarser one); so does this module, a step a 4-tap
stencil in torch.
"""

from __future__ import annotations

import torch

from .shifts import PaddedView


def _avg4(u):
    pv = PaddedView(u, 1)
    return 0.25 * (pv.at(-1, 0) + pv.at(1, 0) + pv.at(0, -1) + pv.at(0, 1))


def _jacobi(diff, mask, init, iters: int):
    u = init
    for _ in range(iters):
        u = torch.where(mask, _avg4(u), diff)
    return u


def _down2(x):
    return x[..., ::2, :][..., :, ::2]


def _up2(x, shape):
    h, w = shape
    out = torch.repeat_interleave(torch.repeat_interleave(x, 2, dim=-2), 2,
                                  dim=-1)
    return out[..., :h, :w]


def heal(dst: torch.Tensor, src: torch.Tensor, mask: torch.Tensor,
         iters: int = 96) -> torch.Tensor:
    """dst, src: (C, H, W); mask: (H, W) in [0, 1].  -> healed dst."""
    hard = mask > 0.5
    diff = torch.where(hard[None], 0.0, dst - src)

    # the three-level coarse-to-fine seed
    d1, m1 = _down2(diff), _down2(hard)
    d2, m2 = _down2(d1), _down2(m1)
    u2 = _jacobi(d2, m2[None], d2, iters)
    u1 = _jacobi(d1, m1[None], torch.where(m1[None],
                                           _up2(u2, d1.shape[-2:]), d1),
                 iters)
    u = _jacobi(diff, hard[None], torch.where(hard[None],
                                              _up2(u1, diff.shape[-2:]),
                                              diff), iters)
    healed = src + u
    return dst * (1.0 - mask)[None] + healed * mask[None]
