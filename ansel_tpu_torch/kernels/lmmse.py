"""LMMSE Bayer demosaic (Zhang & Wu's directional linear minimum
mean-square-error estimate), `ansel_tpu/kernels/lmmse.py` in torch.

Behavioural reference: `ansel/src/iop/demosaic/lmmse.c` (the gamma curve
demosaic.c:1160-1165; G-R/G-B directional estimates lmmse.c:208-244; the
9-tap exponential low-pass :247-259; the per-direction LMMSE variance
blend :261-320; R/B bilinear :339-363; median passes :373-483; EECI
refinement :486-545).

Plain torch, as the JAX package's XLA code: every step is elementwise
over shifted views of edge-padded planes (`pixel/shifts.PaddedView`) and
parity masks (`ops/_bayer`), in the JAX function's order.  Borders: the
reference zeroes data outside the frame in each tile; here, as in the
JAX package, the pad repeats the edge, so the outer ~6 px ring differs.
"""

from __future__ import annotations

import math

import torch

from ..core.types import CFAPattern
from ..ops import _bayer
from ..pixel.shifts import PaddedView


def reach(refine: int) -> int:
    """How far from an output pixel the mosaic decides it: 2 for the
    directional estimates, 4 for the low-pass, 4 for the LMMSE taps, 1
    and 1 for the bilinear R/B at G and at the opposite sites, then 1 a
    median pass and 6 an EECI step (2 for G at R/B, 2 for R/B at G, 2 for
    R at B and B at R)."""
    medians = refine if refine < 2 else 3
    return 12 + medians + 6 * max(0, refine - 2)


def _gamma_in(x):
    """(x <= 0.001867) ? 17 x : 1.044445 x^(1/2.4) - 0.044445."""
    xp = torch.clamp(x, min=1e-12)
    return torch.where(x <= 0.001867, x * 17.0,
                       1.044445 * torch.exp(torch.log(xp) / 2.4) - 0.044445)


def _gamma_out(x):
    """The inverse of _gamma_in."""
    xp = torch.clamp((x + 0.044445) / 1.044445, min=1e-12)
    return torch.where(x <= 0.031746, x / 17.0, torch.exp(torch.log(xp) * 2.4))


def _median3(a, b, c):
    return torch.maximum(torch.minimum(a, b),
                         torch.minimum(c, torch.maximum(a, b)))


def _median9(vs):
    """The reference's 9-element network, op for op (lmmse.c:74-115).

    Not a textbook median: lmmse.c:99 assigns ``a5 = fminf(a4, a5)``
    (a4 and a5 both take the min) and :101-102 leave a7 untouched, as
    the JAX package transcribes them."""
    v = list(vs)
    for i, j in ((1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2)):
        v[i], v[j] = torch.minimum(v[i], v[j]), torch.maximum(v[i], v[j])
    t45 = torch.minimum(v[4], v[5])
    v[4] = t45
    v[5] = t45
    tmp = torch.minimum(v[7], v[8])
    v[8] = torch.maximum(v[7], v[8])
    v[3] = torch.maximum(v[0], v[3])
    v[5] = torch.minimum(v[5], v[8])
    a7 = torch.maximum(v[4], tmp)
    tmp = torch.minimum(v[4], tmp)
    v[6] = torch.maximum(v[3], v[6])
    v[4] = torch.maximum(v[1], tmp)
    v[2] = torch.minimum(v[2], v[5])
    v[4] = torch.minimum(v[4], a7)
    tmp = torch.minimum(v[4], v[2])
    v[2] = torch.maximum(v[4], v[2])
    v[4] = torch.maximum(v[6], tmp)
    return torch.minimum(v[4], v[2])


def _med9_of(plane):
    pv = PaddedView(plane, 1)
    return _median9([pv.at(dy, dx) for dy in (-1, 0, 1)
                     for dx in (-1, 0, 1)])


def _lmmse_dir(lp, diff, vertical):
    """The LMMSE estimate along one direction and its variance
    (lmmse.c:261-320)."""
    plp = PaddedView(lp, 4)
    pdf = PaddedView(diff, 4)
    taps = [(plp.at(k, 0) if vertical else plp.at(0, k))
            for k in range(-4, 5)]
    mu = sum(taps) / 9.0
    vx = 1e-7 + sum((t - mu) ** 2 for t in taps)
    dtaps = [(pdf.at(k, 0) if vertical else pdf.at(0, k))
             for k in range(-4, 5)]
    vn = 1e-7 + sum((t - d) ** 2 for t, d in zip(taps, dtaps))
    xv = (diff * vx + lp * vn) / (vx + vn)
    vv = vx * vn / (vx + vn)
    return xv, vv


def _eeci(R, G, B, rmask, gmask, bmask):
    """One EECI refinement step (lmmse.c:497-545): G at R/B sites, R/B at
    G sites, then R at B sites and B at R sites."""
    pG = PaddedView(G, 2)
    for cmask, C in ((rmask, R), (bmask, B)):
        pC = PaddedView(C, 2)
        dh = torch.abs(pG.at(0, 1) - pG.at(0, -1))
        dv = torch.abs(pG.at(1, 0) - pG.at(-1, 0))
        dL = 1.0 / (1.0 + torch.abs(pC.at(0, -2) - C) + dh)
        dR = 1.0 / (1.0 + torch.abs(pC.at(0, 2) - C) + dh)
        dU = 1.0 / (1.0 + torch.abs(pC.at(-2, 0) - C) + dv)
        dD = 1.0 / (1.0 + torch.abs(pC.at(2, 0) - C) + dv)
        val = C + ((pG.at(0, -1) - pC.at(0, -1)) * dL
                   + (pG.at(0, 1) - pC.at(0, 1)) * dR
                   + (pG.at(-1, 0) - pC.at(-1, 0)) * dU
                   + (pG.at(1, 0) - pC.at(1, 0)) * dD) \
            / (dL + dR + dU + dD)
        G = torch.where(cmask, val, G)
    # R/B at G sites: |G(+-2) - G| and the colour's lateral difference
    # (lmmse.c:516-529)
    pG = PaddedView(G, 2)
    new = []
    for C in (R, B):
        pC = PaddedView(C, 2)
        dch = torch.abs(pC.at(0, 1) - pC.at(0, -1))
        dcv = torch.abs(pC.at(1, 0) - pC.at(-1, 0))
        dL = 1.0 / (1.0 + torch.abs(pG.at(0, -2) - G) + dch)
        dR = 1.0 / (1.0 + torch.abs(pG.at(0, 2) - G) + dch)
        dU = 1.0 / (1.0 + torch.abs(pG.at(-2, 0) - G) + dcv)
        dD = 1.0 / (1.0 + torch.abs(pG.at(2, 0) - G) + dcv)
        val = G - ((pG.at(0, -1) - pC.at(0, -1)) * dL
                   + (pG.at(0, 1) - pC.at(0, 1)) * dR
                   + (pG.at(-1, 0) - pC.at(-1, 0)) * dU
                   + (pG.at(1, 0) - pC.at(1, 0)) * dD) \
            / (dL + dR + dU + dD)
        new.append(torch.where(gmask, val, C))
    R, B = new
    # R at B sites, B at R sites: the site's own measured differences and
    # the lateral G (lmmse.c:531-545)
    pG = PaddedView(G, 2)
    gh = torch.abs(pG.at(0, 1) - pG.at(0, -1))
    gv = torch.abs(pG.at(1, 0) - pG.at(-1, 0))
    new = []
    for C, own, smask in ((R, B, bmask), (B, R, rmask)):
        pC = PaddedView(C, 2)
        pD = PaddedView(own, 2)
        dL = 1.0 / (1.0 + torch.abs(pD.at(0, -2) - own) + gh)
        dR = 1.0 / (1.0 + torch.abs(pD.at(0, 2) - own) + gh)
        dU = 1.0 / (1.0 + torch.abs(pD.at(-2, 0) - own) + gv)
        dD = 1.0 / (1.0 + torch.abs(pD.at(2, 0) - own) + gv)
        val = G - ((pG.at(0, -1) - pC.at(0, -1)) * dL
                   + (pG.at(0, 1) - pC.at(0, 1)) * dR
                   + (pG.at(-1, 0) - pC.at(-1, 0)) * dU
                   + (pG.at(1, 0) - pC.at(1, 0)) * dD) \
            / (dL + dR + dU + dD)
        new.append(torch.where(smask, val, C))
    return new[0], G, new[1]


def lmmse_demosaic(x: torch.Tensor, cfa: CFAPattern, scaler,
                   refine: int = 0) -> torch.Tensor:
    """(H, W) Bayer mosaic -> (3, H, W).  refine is the lmmse_refine
    parameter: 0 or 1 median passes; 2 gives 3 medians; 3 and 4 give 3
    medians and 1 or 2 EECI refinement steps."""
    h, w = x.shape
    medians = refine if refine < 2 else 3
    refines = max(0, refine - 2)

    rmask, gmask, bmask = _bayer.color_masks(cfa, h, w, x.device).bool()
    rbmask = rmask | bmask
    # R rows: rows whose non-green sites are red
    red_row_parity = 0 if 0 in (cfa.color_at(0, 0), cfa.color_at(0, 1)) \
        else 1
    rp, _ = _bayer.parity_maps(h, w, device=x.device)
    rrow = (rp == red_row_parity).expand(h, w)

    cfa_g = _gamma_in(torch.clamp(x / scaler, min=0.0))
    p = PaddedView(cfa_g, 4)

    # directional G-R / G-B estimates (lmmse.c:208-244)
    v0 = 0.0625 * (p.at(-1, -1) + p.at(-1, 1) + p.at(1, -1) + p.at(1, 1)) \
        + 0.25 * cfa_g
    hse = -0.25 * (p.at(0, -2) + p.at(0, 2)) \
        + 0.5 * (p.at(0, -1) + cfa_g + p.at(0, 1))
    vse = -0.25 * (p.at(-2, 0) + p.at(2, 0)) \
        + 0.5 * (p.at(-1, 0) + cfa_g + p.at(1, 0))
    y0 = v0 + 0.5 * hse
    y1 = v0 + 0.5 * vse
    h_rb = torch.where(cfa_g > 1.75 * y0,
                       _median3(hse, p.at(0, -1), p.at(0, 1)),
                       torch.clamp(hse, 0.0, 1.0)) - cfa_g
    v_rb = torch.where(cfa_g > 1.75 * y1,
                       _median3(vse, p.at(-1, 0), p.at(1, 0)),
                       torch.clamp(vse, 0.0, 1.0)) - cfa_g
    h_g = torch.clamp(-hse, -1.0, 0.0) + cfa_g
    v_g = torch.clamp(-vse, -1.0, 0.0) + cfa_g
    hdiff = torch.where(rbmask, h_rb, h_g)
    vdiff = torch.where(rbmask, v_rb, v_g)
    del p, v0, hse, vse, y0, y1, h_rb, v_rb, h_g, v_g

    # the 9-tap exponential low-pass (lmmse.c:142-151, 247-259)
    hk = [math.exp(-(k * k) / 8.0) for k in range(5)]
    hs = hk[0] + 2.0 * sum(hk[1:])
    hk = [v / hs for v in hk]
    ph = PaddedView(hdiff, 4)
    pv = PaddedView(vdiff, 4)
    hlp = hk[0] * hdiff + sum(hk[k] * (ph.at(0, -k) + ph.at(0, k))
                              for k in range(1, 5))
    vlp = hk[0] * vdiff + sum(hk[k] * (pv.at(-k, 0) + pv.at(k, 0))
                              for k in range(1, 5))
    del ph, pv

    xh, vh = _lmmse_dir(hlp, hdiff, False)
    xv, vv = _lmmse_dir(vlp, vdiff, True)
    interp = (xh * vv + xv * vh) / (vh + vv)
    del xh, vh, xv, vv, hlp, vlp, hdiff, vdiff

    # the planes (lmmse.c:323-336)
    G = torch.where(rbmask, cfa_g + interp, cfa_g)
    R = torch.where(rmask, cfa_g, 0.0)
    B = torch.where(bmask, cfa_g, 0.0)
    del interp

    # bilinear R/B at G, then at the opposite sites (lmmse.c:339-363)
    pG = PaddedView(G, 1)
    pR = PaddedView(R, 1)
    pB = PaddedView(B, 1)
    r_h = G + 0.5 * (pR.at(0, -1) - pG.at(0, -1) + pR.at(0, 1)
                     - pG.at(0, 1))
    r_v = G + 0.5 * (pR.at(-1, 0) - pG.at(-1, 0) + pR.at(1, 0)
                     - pG.at(1, 0))
    b_h = G + 0.5 * (pB.at(0, -1) - pG.at(0, -1) + pB.at(0, 1)
                     - pG.at(0, 1))
    b_v = G + 0.5 * (pB.at(-1, 0) - pG.at(-1, 0) + pB.at(1, 0)
                     - pG.at(1, 0))
    R = torch.where(gmask, torch.where(rrow, r_h, r_v), R)
    B = torch.where(gmask, torch.where(rrow, b_v, b_h), B)
    del r_h, r_v, b_h, b_v

    pG = PaddedView(G, 1)
    pR = PaddedView(R, 1)
    pB = PaddedView(B, 1)

    def axial4(pc, pg):
        return 0.25 * (pc.at(-1, 0) - pg.at(-1, 0) + pc.at(0, -1)
                       - pg.at(0, -1) + pc.at(0, 1) - pg.at(0, 1)
                       + pc.at(1, 0) - pg.at(1, 0))

    R = torch.where(bmask, G + axial4(pR, pG), R)
    B = torch.where(rmask, G + axial4(pB, pG), B)
    del pG, pR, pB

    # median passes (lmmse.c:373-483)
    for _ in range(medians):
        corr_r = _med9_of(R - G)
        corr_b = _med9_of(B - G)
        newR = torch.where(gmask, G + corr_r, R)
        newB = torch.where(gmask, G + corr_b, B)
        newR = torch.where(bmask, G + corr_r, newR)
        newB = torch.where(rmask, G + corr_b, newB)
        newG = torch.where(rbmask,
                           0.5 * (newR - corr_r + newB - corr_b), G)
        R, G, B = newR, newG, newB
        del corr_r, corr_b, newR, newG, newB

    # the measured channel from the gamma'd mosaic (lmmse.c:486-495)
    R = torch.where(rmask, cfa_g, R)
    G = torch.where(gmask, cfa_g, G)
    B = torch.where(bmask, cfa_g, B)

    for _ in range(refines):
        R, G, B = _eeci(R, G, B, rmask, gmask, bmask)

    out = torch.stack([_gamma_out(R), _gamma_out(G), _gamma_out(B)])
    return torch.clamp(out * scaler, min=0.0)
