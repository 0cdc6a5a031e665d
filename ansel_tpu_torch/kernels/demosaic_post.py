"""Demosaic pre- and post-passes: green equilibration and colour
smoothing (`ansel_tpu/kernels/demosaic_post.py`).

Reference: `ansel/src/iop/demosaic/basic.c` — green_equilibration_lavg
(:248-295, the local 2x2 green imbalance fix), green_equilibration_favg
(:296-330, the global green-phase ratio), color_smoothing (:192-246, N
passes of a 9-point median on R-G and B-G).

Plain torch, as the JAX package's XLA code: whole-plane shifted views of
an edge-padded plane (`pixel/shifts.PaddedView`), each pixel's float32
operations in the JAX function's order; the 9-point median is the
reference's 19-comparator network as elementwise min/max.
"""

from __future__ import annotations

import torch

from ..core.types import CFAPattern
from ..pixel.shifts import PaddedView

GREEN_EQ_LOCAL = 1
GREEN_EQ_FULL = 2
GREEN_EQ_BOTH = 3
# how far from a pixel each pass reads: the local equilibration's o2
# ring, and one 3x3 median a colour-smoothing pass
LAVG_REACH = 2
SMOOTH_REACH = 1


def _site_mask(h: int, w: int, py: int, px: int, device) -> torch.Tensor:
    """(h, w) bool: the sites at row parity py and column parity px."""
    rows = (torch.arange(h, device=device) % 2 == py)[:, None]
    cols = (torch.arange(w, device=device) % 2 == px)[None, :]
    return rows & cols


def _green_phase_masks(cfa: CFAPattern, h: int, w: int, device):
    """(g1, g2): the two green sites of the 2x2 cell, g1 the first green
    in reading order (the one the reference anchors at (oj, oi))."""
    greens = [(y, x) for y in range(2) for x in range(2)
              if cfa.color_at(y, x) == 1]
    g1 = _site_mask(h, w, *greens[0], device)
    g2 = torch.zeros((h, w), dtype=torch.bool, device=device)
    for y, x in greens[1:]:
        g2 = g2 | _site_mask(h, w, y, x, device)
    return g1, g2 & ~g1


def _lavg_phase(cfa: CFAPattern):
    """The green phase the reference anchors at (basic.c:253-257: the
    first green site at or after (2, 2), probing (oj, oi) -> (oj+1, oi)
    -> (oj+1, oi+1) -> (oj, oi+1))."""
    for oj, oi in ((2, 2), (3, 2), (3, 3), (2, 3)):
        if cfa.color_at(oj % 2, oi % 2) == 1:
            return oj % 2, oi % 2
    return 0, 0


def green_eq_lavg(x: torch.Tensor, cfa: CFAPattern, thr: float):
    """Local average equilibration (basic.c:248-295): corrects ONE green
    phase toward its diagonal (other-phase) neighbours."""
    h, w = x.shape
    is_g = _site_mask(h, w, *_lavg_phase(cfa), x.device)
    pv = PaddedView(x, 2)
    o1 = [pv.at(-1, -1), pv.at(-1, 1), pv.at(1, -1), pv.at(1, 1)]
    o2 = [pv.at(-2, 0), pv.at(2, 0), pv.at(0, -2), pv.at(0, 2)]
    m1 = sum(o1) / 4.0
    m2 = sum(o2) / 4.0

    def spread(o):
        return (torch.abs(o[0] - o[1]) + torch.abs(o[0] - o[2])
                + torch.abs(o[0] - o[3]) + torch.abs(o[1] - o[2])
                + torch.abs(o[2] - o[3]) + torch.abs(o[1] - o[3])) / 6.0

    c1, c2 = spread(o1), spread(o2)
    ratio = m1 / torch.clamp(m2, min=1e-12)
    ok = ((m2 > 0.0) & (m1 > 0.0) & (ratio < 2.0) & (x < 0.95)
          & (c1 < thr) & (c2 < thr) & is_g)
    return torch.where(ok, x * m1 / torch.clamp(m2, min=1e-12), x)


def green_eq_favg(x: torch.Tensor, cfa: CFAPattern):
    """Global green-phase ratio equilibration (basic.c:296-330): one
    reduction per phase, the ratio kept on the device."""
    h, w = x.shape
    g1, g2 = _green_phase_masks(cfa, h, w, x.device)
    sum1 = torch.sum(torch.where(g1, x, 0.0))
    sum2 = torch.sum(torch.where(g2, x, 0.0))
    ratio = torch.where((sum1 > 0) & (sum2 > 0),
                        sum2 / torch.clamp(sum1, min=1e-12),
                        torch.ones_like(sum1))
    return torch.where(g1, x * ratio, x)


def apply_green_eq(x: torch.Tensor, cfa: CFAPattern, mode: int,
                   thr: float) -> torch.Tensor:
    """Mode 1 local, 2 full, 3 full then local."""
    if mode in (GREEN_EQ_FULL, GREEN_EQ_BOTH):
        x = green_eq_favg(x, cfa)
    if mode in (GREEN_EQ_LOCAL, GREEN_EQ_BOTH):
        x = green_eq_lavg(x, cfa, thr)
    return x


_NETWORK9 = ((1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2),
             (4, 5), (7, 8), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4),
             (2, 5), (4, 7), (4, 2), (6, 4), (4, 2))


def _median9(vals):
    """The optimal 9-element median sorting network (basic.c:219-240)."""
    v = list(vals)
    for a, b in _NETWORK9:
        v[a], v[b] = torch.minimum(v[a], v[b]), torch.maximum(v[a], v[b])
    return v[4]


def color_smoothing(rgb: torch.Tensor, passes: int) -> torch.Tensor:
    """(3, H, W): N passes of the 9-point median on R-G and B-G
    (basic.c:192-246), G kept; the edge-padded border takes part."""
    r, g, b = rgb[0], rgb[1], rgb[2]
    for _ in range(passes):
        for idx in (0, 2):
            plane = r if idx == 0 else b
            pv = PaddedView(plane - g, 1)
            med = _median9([pv.at(dy, dx) for dy in (-1, 0, 1)
                            for dx in (-1, 0, 1)])
            new = torch.clamp(med + g, min=0.0)
            if idx == 0:
                r = new
            else:
                b = new
    return torch.stack([r, g, b])
