"""Bayer helpers shared by mosaic-stage ops (`ansel_tpu/ops/_bayer.py`).

The reference addresses CFA sites through the FC() macro and a position
index ``((row + phase_y) & 1) << 1 | ((col + phase_x) & 1)``
(`ansel/src/iop/rawprepare.c:385-390`).  As in the JAX package, parity
maps come from `arange` and the 4-way choice is three `where`s, so no
table is copied from the host to the device.  X-Trans helpers wait for
the X-Trans slice.
"""

from __future__ import annotations

import torch

from ..core.types import CFAPattern


def parity_maps(h: int, w: int, phase_y: int = 0, phase_x: int = 0,
                device=None):
    """-> (row_parity, col_parity) int64 tensors of shape (h, 1), (1, w)."""
    rp = (torch.arange(h, device=device) + phase_y) % 2
    cp = (torch.arange(w, device=device) + phase_x) % 2
    return rp[:, None], cp[None, :]


def position_select(vals4, h: int, w: int, phase_y: int = 0,
                    phase_x: int = 0, device=None) -> torch.Tensor:
    """(h, w) float32 plane from 4 values indexed by 2x2 CFA *position*
    (reference BL() indexing): a (4,) tensor, or a sequence of four
    0-dim tensors or Python floats."""
    if isinstance(vals4, torch.Tensor):
        device = vals4.device
    v = [torch.as_tensor(vals4[i], dtype=torch.float32, device=device)
         for i in range(4)]
    rp, cp = parity_maps(h, w, phase_y, phase_x, v[0].device)
    top = torch.where(cp == 0, v[0], v[1])       # row parity 0
    bot = torch.where(cp == 0, v[2], v[3])       # row parity 1
    return torch.where(rp == 0, top, bot)


def color_select(vals_rgbg, cfa: CFAPattern, h: int, w: int,
                 device=None) -> torch.Tensor:
    """Per-pixel value from (R, G, B, G2) indexed by CFA *color* at each
    site; the second green site uses G2 (reference temperature.c FC path)."""
    vals = []
    seen_green = False
    for y in range(2):
        for x in range(2):
            c = cfa.color_at(y, x)
            if c == 1:
                vals.append(vals_rgbg[3] if seen_green else vals_rgbg[1])
                seen_green = True
            else:
                vals.append(vals_rgbg[c])
    if isinstance(vals_rgbg, torch.Tensor):
        device = vals_rgbg.device
    return position_select(vals, h, w, device=device)


def color_masks(cfa: CFAPattern, h: int, w: int, device=None) -> torch.Tensor:
    """(3, h, w) float32 one-hot masks: which sites carry R / G / B."""
    rp, cp = parity_maps(h, w, device=device)
    pos = rp * 2 + cp
    masks = []
    for color in range(3):
        sel = torch.zeros((h, w), dtype=torch.bool, device=device)
        for y in range(2):
            for x in range(2):
                if cfa.color_at(y, x) == color:
                    sel = sel | (pos == y * 2 + x)
        masks.append(sel)
    return torch.stack(masks).float()
