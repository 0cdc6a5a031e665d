"""Bayer helpers shared by mosaic-stage ops (`ansel_tpu/ops/_bayer.py`).

The reference addresses CFA sites through the FC() macro and a position
index ``((row + phase_y) & 1) << 1 | ((col + phase_x) & 1)``
(`ansel/src/iop/rawprepare.c:385-390`).  Here the 2x2 period is built
once as a small tensor and tiled over the plane.  X-Trans helpers wait
for the X-Trans slice.
"""

from __future__ import annotations

import torch

from ..core.types import CFAPattern


def position_select(vals4, h: int, w: int, phase_y: int = 0,
                    phase_x: int = 0, device=None) -> torch.Tensor:
    """(h, w) float32 plane from a 4-vector indexed by 2x2 CFA *position*
    (reference BL() indexing).  vals4 is a sequence of 4 scalars or a
    (4,) tensor."""
    v = torch.as_tensor(vals4, dtype=torch.float32, device=device)
    rp = (torch.arange(h, device=v.device) + phase_y) % 2
    cp = (torch.arange(w, device=v.device) + phase_x) % 2
    return v[rp[:, None] * 2 + cp[None, :]]


def color_select(vals_rgbg, cfa: CFAPattern, h: int, w: int,
                 device=None) -> torch.Tensor:
    """Per-pixel value from (R, G, B, G2) indexed by CFA *color* at each
    site; the second green site uses G2 (reference temperature.c FC path)."""
    idx = []
    seen_green = False
    for y in range(2):
        for x in range(2):
            c = cfa.color_at(y, x)
            if c == 1:
                idx.append(3 if seen_green else 1)
                seen_green = True
            else:
                idx.append(c)
    v = torch.as_tensor(vals_rgbg, dtype=torch.float32, device=device)
    return position_select(v[idx], h, w, device=v.device)


def color_masks(cfa: CFAPattern, h: int, w: int, device=None) -> torch.Tensor:
    """(3, h, w) float32 one-hot masks: which sites carry R / G / B."""
    rp = torch.arange(h, device=device) % 2
    cp = torch.arange(w, device=device) % 2
    pos = rp[:, None] * 2 + cp[None, :]
    color = torch.tensor([cfa.color_at(y, x) for y in range(2)
                          for x in range(2)], device=device)[pos]
    return torch.stack([(color == c).float() for c in range(3)])
