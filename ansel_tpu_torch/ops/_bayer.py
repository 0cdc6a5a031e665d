"""Bayer helpers shared by mosaic-stage ops (`ansel_tpu/ops/_bayer.py`).

The reference addresses CFA sites through the FC() macro and a position
index ``((row + phase_y) & 1) << 1 | ((col + phase_x) & 1)``
(`ansel/src/iop/rawprepare.c:385-390`).  As in the JAX package, parity
maps come from `arange` and the 4-way choice is three `where`s, so no
table is copied from the host to the device.  The X-Trans helpers build
one 6 x 6 period on the device and tile it.
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


def xtrans_period(pattern6, device):
    """(6, 6) int64 colour index of one X-Trans period, built on `device`
    from arange (no host copy)."""
    pos = torch.arange(36, device=device).reshape(6, 6)
    color = torch.zeros((6, 6), dtype=torch.int64, device=device)
    for k, c in enumerate(pattern6):
        if c:
            color = torch.where(pos == k, c, color)
    return color


def tile6(period, h: int, w: int) -> torch.Tensor:
    """A (6, 6) period repeated over an (h, w) frame."""
    return period.repeat(-(-h // 6), -(-w // 6))[:h, :w]


def xtrans_color_select(vals_rgb, pattern6, h: int, w: int,
                        device=None) -> torch.Tensor:
    """(h, w) float32 plane: vals_rgb[colour] at each site of a 6x6 X-Trans
    pattern (a tuple of 36 colour ids, row-major); vals_rgb is a tensor or
    a sequence of three 0-dim tensors or Python floats."""
    if isinstance(vals_rgb, torch.Tensor):
        device = vals_rgb.device
    v = [torch.as_tensor(vals_rgb[i], dtype=torch.float32, device=device)
         for i in range(3)]
    period = torch.stack([v[c] for c in pattern6]).reshape(6, 6)
    return tile6(period, h, w)
