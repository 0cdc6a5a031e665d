"""AMaZE demosaic (Aliasing Minimization and Zipper Elimination) on a
Bayer mosaic: `ansel_tpu/kernels/amaze.py` in torch.

Behavioural reference: `ansel/src/iop/demosaic/amaze.cc`
(amaze_demosaic_RT :181-1417, E. Martinec / I. Weyrich), re-derived by
the JAX package as whole-image masked shifted-view math with its twelve
stages:

  1. directional gradients dirwts0/1 and delhvsqsum          (:464-474)
  2. H/V colour differences, Hamilton-Adams and adaptive-ratio
     variants, the highlight fallback, dgintv/dginth           (:476-582)
  3. variance-based HA/AR selection and saturation bounding    (:585-705)
  4. directional colour-difference variances -> hvwt          (:707-760)
  5. the Nyquist texture test, neighbour consensus, area
     interpolation                                             (:762-890)
  6. G at R/B sites with the Nyquist curvature refinement      (:893-955)
  7. diagonal gradients delp/delm, Dgrbsq1p/m                  (:957-981)
  8. diagonal R/B interpolation rbp/rbm, pmwt, bounding        (:983-1107)
  9. pmwt neighbour escalation, rbint                          (:1109-1126)
 10. G re-interpolated from R+B where the diagonal
     discrimination beats the cardinal one                     (:1129-1233)
 11. the diagonal chrominance interpolation of the missing
     colour difference at R/B sites                            (:1237-1276)
 12. R/B at G sites from hvwt-weighted cardinal differences    (:1278-1410)

Every stage but two is elementwise over reflect-padded shifted views, in
the JAX function's order.  The two others carry the reference's in-place,
row-major semantics, which the JAX package evaluates with `lax.scan`:

  * stage 3 (`_stage3_seq`): each hcd (vcd) value's variance reads the
    selected and bounded value two columns (rows) back.  Here a Python
    loop along that axis, vectorised over the other; a step reads only
    the value two back, so the even and the odd lines are two
    independent chains and each step advances both (two lines at once);
  * the hvwt and pmwt escalations (`_escalate_rows`): row r reads the
    escalated row r - 1 and the raw row r + 1, one row a step.

Each loop writes into a preallocated plane by index, slices its per-step
inputs from planes made before the loop, and reads nothing back to the
host.  At 24 MP that is about 3 000 + 2 000 + 2 x 4 000 sequential steps
of small launches: seconds per image, plain torch as on the TPU, where
the JAX package runs XLA.
"""

from __future__ import annotations

import torch

from ..core.types import CFAPattern
from ..ops import _bayer
from ..pixel.shifts import PaddedView

EPS = 1e-5
EPSSQ = 1e-10
ARTHRESH = 0.75
NYQTHRESH = 0.5
GAUSSODD = (0.14659727707323927, 0.103592713382435,
            0.0732036125103057, 0.0365543548389495)
GAUSSGRAD = tuple(NYQTHRESH * g for g in (
    0.07384411893421103, 0.06207511968171489, 0.0521818194747806,
    0.03687419286733595, 0.03099732204057846, 0.018413194161458882))
GAUSSEVEN = (0.13719494435797422, 0.05640252782101291)
GQUINC = (0.169917, 0.108947, 0.069855, 0.0287182)

# How far below an output pixel the mosaic decides it (and, the code being
# symmetric, how far right), along the longest chain of reads: vcd 4 rows
# (stage 2's d0.at(2, 0) of dirwts0, itself 2), 6 after stage 3's
# look-ahead to line i + 2, 8 and 10 after the Nyquist test's cd.at(2, .)
# and its consensus, 16 after the 7x7 area sums' n2.at(6, .), 17 after
# the hvwt escalation's row r + 1, 18 and 20 after the curvature test's
# g.at(1, 0) and gquinc_sum's 2, 23 after `fancy`'s d.at(3, .), 24 after
# R/B at G sites.  Rows above reach without bound: stage 3 (vcd down the
# rows, hcd along them) and the hvwt and pmwt escalations carry each
# line's result to the next, and the escalations spread it a column a
# row.  So a window computes the frame's values on its rows only when it
# starts at the frame's first row, spans its columns and ends REACH rows
# below them (`ops/demosaic.Demosaic.roi_in` under `exact_window`).
REACH = 24


def _ulim(x, y, z):
    """dt's ULIM: clamp x into [min(y, z), max(y, z)]."""
    return torch.clamp(x, torch.minimum(y, z), torch.maximum(y, z))


def _bound_g(cd, gint, lo, hi, c0, clip_pt):
    """Green-site bounding (:618-654), cd = G - X; [lo, hi] the
    neighbours' range."""
    ulim = -torch.clamp(gint, lo, hi) + c0
    big = 3.0 * cd > (gint + c0)
    w = 1.0 - 3.0 * cd / (EPS + gint + c0)
    bounded = torch.where(big, ulim, w * cd + (1.0 - w) * ulim)
    cd = torch.where(cd > 0, bounded, cd)
    return torch.where(gint > clip_pt, ulim, cd)


def _bound_rb(cd, gint, lo, hi, c0, clip_pt):
    """R/B-site bounding (:662-698), cd = G - X, X the mosaic."""
    ulim = torch.clamp(gint, lo, hi) - c0
    big = 3.0 * cd < -(gint + c0)
    w = 1.0 + 3.0 * cd / (EPS + gint + c0)
    bounded = torch.where(big, ulim, w * cd + (1.0 - w) * ulim)
    cd = torch.where(cd < 0, bounded, cd)
    return torch.where(gint > clip_pt, ulim, cd)


def _var3(a, b, c):
    return 3.0 * (a * a + b * b + c * c) - (a + b + c) ** 2


def _stage3_seq(raw, alt, gmask, c0, n1, n2, clip_pt, axis: int):
    """Stage 3's variance selection and bounding in the reference's
    in-place order (:585-705) along `axis`: line i's variance reads the
    finished line i - 2; lines outside [4, N - 4) keep `raw`."""
    def lines(a):
        return (a if axis == 0 else a.t()).contiguous()

    rawT, altT = lines(raw), lines(alt)
    N = rawT.shape[0]
    out = rawT.clone()
    if N <= 8:
        return out if axis == 0 else out.t()
    # the carry-free parts, whole planes with the JAX step's operations
    lo = lines(torch.minimum(n1, n2))
    hi = lines(torch.maximum(n1, n2))
    gm, cc = lines(gmask), lines(c0)
    avar = torch.zeros_like(rawT)
    avar[2:-2] = _var3(altT[:-4], altT[2:-2], altT[4:])
    rsq = rawT * rawT
    rp2 = torch.zeros_like(rawT)
    rp2[:-2] = rawT[2:]
    rp2sq = rp2 * rp2
    for i in range(4, N - 4, 2):
        j = min(i + 2, N - 4)
        u2 = out[i - 2:j - 2]
        r, p2 = rawT[i:j], rp2[i:j]
        var = 3.0 * (u2 * u2 + rsq[i:j] + rp2sq[i:j]) - (u2 + r + p2) ** 2
        sel = torch.where(avar[i:j] < var, altT[i:j], r)
        c, l_, h_ = cc[i:j], lo[i:j], hi[i:j]
        out[i:j] = torch.where(
            gm[i:j], _bound_g(sel, -sel + c, l_, h_, c, clip_pt),
            _bound_rb(sel, sel + c, l_, h_, c, clip_pt))
    return out if axis == 0 else out.t()


def _escalate_rows(w, start_row: int, margin: int):
    """The neighbour escalation (hvwt :899-905, pmwt :1113-1119) in the
    reference's in-place row order: row r's diagonal average reads the
    escalated row r - 1 and the raw row r + 1; rows outside [start_row,
    H - start_row) and columns outside [margin, W - margin) keep `w`."""
    H, W = w.shape
    out = w.clone()
    c0, c1 = margin, W - margin
    if c1 <= c0:
        return out
    dist = torch.abs(0.5 - w[:, c0:c1])
    nsides = w[:, c0 - 1:c1 - 1], w[:, c0 + 1:c1 + 1]
    for r in range(start_row, H - start_row):
        prev = out[r - 1]
        alt = 0.25 * (prev[c0 - 1:c1 - 1] + prev[c0 + 1:c1 + 1]
                      + nsides[0][r + 1] + nsides[1][r + 1])
        out[r, c0:c1] = torch.where(dist[r] < torch.abs(0.5 - alt), alt,
                                    w[r, c0:c1])
    return out


def amaze_demosaic(x: torch.Tensor, cfa: CFAPattern,
                   scaler=None) -> torch.Tensor:
    """(H, W) Bayer mosaic -> (3, H, W).  `scaler` is the largest
    processed maximum: the mosaic is divided by it (the reference's input
    is 0..1, amaze.cc:191, so clip_pt is 1.0) and the output multiplied
    back."""
    H, W = x.shape
    dt = x.dtype
    if scaler is not None:
        x = x / torch.as_tensor(scaler, dtype=dt, device=x.device)
    clip_pt = 1.0
    clip_pt8 = 0.8 * clip_pt

    rmask, gmaskf, bmask = _bayer.color_masks(cfa, H, W, x.device)
    gmask = gmaskf > 0
    rb_mask = ~gmask

    c = PaddedView(x, 8, mode="reflect")
    c0 = x

    # 1. gradients (:464-474)
    delh = torch.abs(c.at(0, 1) - c.at(0, -1))
    delv = torch.abs(c.at(1, 0) - c.at(-1, 0))
    dirwts0 = EPS + torch.abs(c.at(2, 0) - c0) \
        + torch.abs(c0 - c.at(-2, 0)) + delv
    dirwts1 = EPS + torch.abs(c.at(0, 2) - c0) \
        + torch.abs(c0 - c.at(0, -2)) + delh
    delhvsqsum = delh * delh + delv * delv
    del delh, delv
    d0 = PaddedView(dirwts0, 4, mode="reflect")
    d1 = PaddedView(dirwts1, 4, mode="reflect")

    # 2. H/V colour differences (:476-582)
    def ratio(num_nb, w_far, w_self, far_nb):
        return num_nb * (w_far + w_self) \
            / (w_far * (EPS + c0) + w_self * (EPS + far_nb))

    cru = ratio(c.at(-1, 0), d0.at(-2, 0), dirwts0, c.at(-2, 0))
    crd = ratio(c.at(1, 0), d0.at(2, 0), dirwts0, c.at(2, 0))
    crl = ratio(c.at(0, -1), d1.at(0, -2), dirwts1, c.at(0, -2))
    crr = ratio(c.at(0, 1), d1.at(0, 2), dirwts1, c.at(0, 2))

    guha = c.at(-1, 0) + 0.5 * (c0 - c.at(-2, 0))
    gdha = c.at(1, 0) + 0.5 * (c0 - c.at(2, 0))
    glha = c.at(0, -1) + 0.5 * (c0 - c.at(0, -2))
    grha = c.at(0, 1) + 0.5 * (c0 - c.at(0, 2))

    def adaptive(cr, ha):
        return torch.where(torch.abs(1.0 - cr) < ARTHRESH, c0 * cr, ha)

    guar, gdar = adaptive(cru, guha), adaptive(crd, gdha)
    glar, grar = adaptive(crl, glha), adaptive(crr, grha)
    del cru, crd, crl, crr

    hwt = d1.at(0, -1) / (d1.at(0, -1) + d1.at(0, 1))
    vwt = d0.at(-1, 0) / (d0.at(1, 0) + d0.at(-1, 0))

    gintv_ha = vwt * gdha + (1.0 - vwt) * guha
    ginth_ha = hwt * grha + (1.0 - hwt) * glha
    gintv_ar = vwt * gdar + (1.0 - vwt) * guar
    ginth_ar = hwt * grar + (1.0 - hwt) * glar

    sgn = torch.where(gmask, 1.0, -1.0).to(dt)
    vcd = sgn * (c0 - gintv_ar)
    hcd = sgn * (c0 - ginth_ar)
    vcdalt = sgn * (c0 - gintv_ha)
    hcdalt = sgn * (c0 - ginth_ha)
    del gintv_ar, ginth_ar, sgn

    hi_clip = (c0 > clip_pt8) | (gintv_ha > clip_pt8) \
        | (ginth_ha > clip_pt8)
    del gintv_ha, ginth_ha
    vcd = torch.where(hi_clip, vcdalt, vcd)
    hcd = torch.where(hi_clip, hcdalt, hcd)
    sq_v_ha = (guha - gdha) ** 2
    sq_h_ha = (glha - grha) ** 2
    dgintv = torch.minimum(sq_v_ha, torch.where(hi_clip, sq_v_ha,
                                                (guar - gdar) ** 2))
    dginth = torch.minimum(sq_h_ha, torch.where(hi_clip, sq_h_ha,
                                                (glar - grar) ** 2))
    del guha, gdha, glha, grha, guar, gdar, glar, grar, sq_v_ha, sq_h_ha
    del hi_clip

    # 3. variance selection and saturation bounding (:585-705), in the
    # reference's sequential order
    cN, cS = c.at(-1, 0), c.at(1, 0)
    cW, cE = c.at(0, -1), c.at(0, 1)
    hcd = _stage3_seq(hcd, hcdalt, gmask, c0, cW, cE, clip_pt, axis=1)
    vcd = _stage3_seq(vcd, vcdalt, gmask, c0, cN, cS, clip_pt, axis=0)
    del hcdalt, vcdalt
    # the reference writes cddiffsq only in the R/B branch (:699): its G
    # sites stay calloc zero under the Nyquist quincunx
    cddiffsq = torch.where(rb_mask, (vcd - hcd) ** 2, 0.0)

    # 4. hvwt at R/B sites (:707-760)
    vp = PaddedView(vcd, 4, mode="reflect")
    hp = PaddedView(hcd, 4, mode="reflect")
    uave = vcd + vp.at(-1, 0) + vp.at(-2, 0) + vp.at(-3, 0)
    dave = vcd + vp.at(1, 0) + vp.at(2, 0) + vp.at(3, 0)
    lave = hcd + hp.at(0, -1) + hp.at(0, -2) + hp.at(0, -3)
    rave = hcd + hp.at(0, 1) + hp.at(0, 2) + hp.at(0, 3)

    def var4(v0, v1_, v2_, v3_, ave):
        return ((v0 - ave) ** 2 + (v1_ - ave) ** 2 + (v2_ - ave) ** 2
                + (v3_ - ave) ** 2)

    dgvu = var4(vcd, vp.at(-1, 0), vp.at(-2, 0), vp.at(-3, 0), uave)
    dgvd = var4(vcd, vp.at(1, 0), vp.at(2, 0), vp.at(3, 0), dave)
    dghl = var4(hcd, hp.at(0, -1), hp.at(0, -2), hp.at(0, -3), lave)
    dghr = var4(hcd, hp.at(0, 1), hp.at(0, 2), hp.at(0, 3), rave)
    del vp, hp, uave, dave, lave, rave
    vcdvar2 = EPSSQ + vwt * dgvd + (1.0 - vwt) * dgvu
    hcdvar2 = EPSSQ + hwt * dghr + (1.0 - hwt) * dghl
    del dgvu, dgvd, dghl, dghr

    gi_v = PaddedView(dgintv, 2, mode="reflect")
    gi_h = PaddedView(dginth, 2, mode="reflect")
    fvu = dgintv + gi_v.at(-1, 0) + gi_v.at(-2, 0)
    fvd = dgintv + gi_v.at(1, 0) + gi_v.at(2, 0)
    fhl = dginth + gi_h.at(0, -1) + gi_h.at(0, -2)
    fhr = dginth + gi_h.at(0, 1) + gi_h.at(0, 2)
    del gi_v, gi_h, dgintv, dginth
    vcdvar1 = EPSSQ + vwt * fvd + (1.0 - vwt) * fvu
    hcdvar1 = EPSSQ + hwt * fhr + (1.0 - hwt) * fhl
    del fvu, fvd, fhl, fhr, hwt, vwt

    varwt = hcdvar2 / (vcdvar2 + hcdvar2)
    diffwt = hcdvar1 / (vcdvar1 + hcdvar1)
    del vcdvar1, vcdvar2, hcdvar1, hcdvar2
    agree = ((0.5 - varwt) * (0.5 - diffwt) > 0) \
        & (torch.abs(0.5 - diffwt) < torch.abs(0.5 - varwt))
    hvwt = torch.where(agree, varwt, diffwt)
    del varwt, diffwt, agree

    # 5. the Nyquist test (:762-890)
    cd = PaddedView(cddiffsq, 4, mode="reflect")
    dh = PaddedView(delhvsqsum, 4, mode="reflect")
    nyqutest = (
        GAUSSODD[0] * cddiffsq
        + GAUSSODD[1] * (cd.at(-1, -1) + cd.at(-1, 1)
                         + cd.at(1, -1) + cd.at(1, 1))
        + GAUSSODD[2] * (cd.at(-2, 0) + cd.at(0, -2)
                         + cd.at(0, 2) + cd.at(2, 0))
        + GAUSSODD[3] * (cd.at(-2, -2) + cd.at(-2, 2)
                         + cd.at(2, -2) + cd.at(2, 2))
    ) - (
        GAUSSGRAD[0] * delhvsqsum
        + GAUSSGRAD[1] * (dh.at(-1, 0) + dh.at(0, 1)
                          + dh.at(0, -1) + dh.at(1, 0))
        + GAUSSGRAD[2] * (dh.at(-1, -1) + dh.at(-1, 1)
                          + dh.at(1, -1) + dh.at(1, 1))
        + GAUSSGRAD[3] * (dh.at(-2, 0) + dh.at(0, -2)
                          + dh.at(0, 2) + dh.at(2, 0))
        + GAUSSGRAD[4] * (dh.at(-2, -1) + dh.at(-2, 1)
                          + dh.at(-1, -2) + dh.at(-1, 2)
                          + dh.at(1, -2) + dh.at(1, 2)
                          + dh.at(2, -1) + dh.at(2, 1))
        + GAUSSGRAD[5] * (dh.at(-2, -2) + dh.at(-2, 2)
                          + dh.at(2, -2) + dh.at(2, 2))
    )
    del cd, dh, cddiffsq, delhvsqsum
    nyquist = ((nyqutest > 0.0) & rb_mask).to(dt)
    del nyqutest
    ny = PaddedView(nyquist, 2, mode="reflect")
    consensus = (ny.at(-2, 0) + ny.at(-1, -1) + ny.at(-1, 1)
                 + ny.at(0, -2) + ny.at(0, 2) + ny.at(1, -1)
                 + ny.at(1, 1) + ny.at(2, 0))
    nyquist2 = torch.where(
        consensus > 4, 1.0,
        torch.where(consensus < 4, 0.0, nyquist)) * rb_mask
    del ny, consensus, nyquist

    # area interpolation over the 7x7 same-coset window (:856-885)
    n2 = PaddedView(nyquist2, 6, mode="reflect")
    sumcfa = torch.zeros_like(c0)
    sumh = torch.zeros_like(c0)
    sumv = torch.zeros_like(c0)
    sumsqh = torch.zeros_like(c0)
    sumsqv = torch.zeros_like(c0)
    areawt = torch.zeros_like(c0)
    for i in range(-6, 7, 2):
        for j in range(-6, 7, 2):
            sel = n2.at(i, j)
            cc_ = c.at(i, j)
            chl = c.at(i, j - 1)
            chr_ = c.at(i, j + 1)
            cvu = c.at(i - 1, j)
            cvd = c.at(i + 1, j)
            sumcfa = sumcfa + sel * cc_
            sumh = sumh + sel * (chl + chr_)
            sumv = sumv + sel * (cvu + cvd)
            sumsqh = sumsqh + sel * ((cc_ - chl) ** 2 + (cc_ - chr_) ** 2)
            sumsqv = sumsqv + sel * ((cc_ - cvu) ** 2 + (cc_ - cvd) ** 2)
            areawt = areawt + sel
    del n2
    sumh = sumcfa - 0.5 * sumh
    sumv = sumcfa - 0.5 * sumv
    areawt = 0.5 * areawt
    hcdvar_a = EPSSQ + torch.abs(areawt * sumsqh - sumh * sumh)
    vcdvar_a = EPSSQ + torch.abs(areawt * sumsqv - sumv * sumv)
    del sumcfa, sumh, sumv, sumsqh, sumsqv, areawt
    ny_on = nyquist2 > 0
    hvwt = torch.where(ny_on, hcdvar_a / (vcdvar_a + hcdvar_a), hvwt)
    del hcdvar_a, vcdvar_a

    # 6. G at R/B sites, with the Nyquist curvature refinement (:893-955);
    # the reference escalates hvwt in place
    hvwt = _escalate_rows(hvwt, 8, 8)
    dgrb0 = hvwt * vcd + (1.0 - hvwt) * hcd
    rgbgreen = torch.where(rb_mask, c0 + dgrb0, c0)

    g = PaddedView(rgbgreen, 2, mode="reflect")
    dgrb2h = torch.where(
        ny_on, (rgbgreen - 0.5 * (g.at(0, -1) + g.at(0, 1))) ** 2, 0.0)
    dgrb2v = torch.where(
        ny_on, (rgbgreen - 0.5 * (g.at(-1, 0) + g.at(1, 0))) ** 2, 0.0)
    del g
    d2h = PaddedView(dgrb2h, 4, mode="reflect")
    d2v = PaddedView(dgrb2v, 4, mode="reflect")

    def gquinc_sum(p):
        return (GQUINC[0] * p.at(0, 0)
                + GQUINC[1] * (p.at(-1, -1) + p.at(-1, 1)
                               + p.at(1, -1) + p.at(1, 1))
                + GQUINC[2] * (p.at(-2, 0) + p.at(0, -2)
                               + p.at(0, 2) + p.at(2, 0))
                + GQUINC[3] * (p.at(-2, -2) + p.at(-2, 2)
                               + p.at(2, -2) + p.at(2, 2)))

    gvarh = EPSSQ + gquinc_sum(d2h)
    gvarv = EPSSQ + gquinc_sum(d2v)
    del d2h, d2v, dgrb2h, dgrb2v
    dgrb0_ny = (hcd * gvarv + vcd * gvarh) / (gvarv + gvarh)
    dgrb0 = torch.where(ny_on, dgrb0_ny, dgrb0)
    rgbgreen = torch.where(rb_mask, c0 + dgrb0, c0)
    del gvarh, gvarv, dgrb0_ny, hcd, vcd, ny_on, nyquist2

    # 7. diagonal gradients (:957-981)
    delp = torch.abs(c.at(-1, 1) - c.at(1, -1))        # at R/B sites
    delm = torch.abs(c.at(1, 1) - c.at(-1, -1))
    dgrbsq1p = (c0 - c.at(1, -1)) ** 2 + (c0 - c.at(-1, 1)) ** 2  # at G
    dgrbsq1m = (c0 - c.at(-1, -1)) ** 2 + (c0 - c.at(1, 1)) ** 2

    # 8. diagonal R/B interpolation at R/B sites (:983-1107)
    def diag_est(dy, dx):
        near, far = c.at(dy, dx), c.at(2 * dy, 2 * dx)
        cr = 2.0 * near / (EPS + c0 + far)
        return torch.where(torch.abs(1.0 - cr) < ARTHRESH, c0 * cr,
                           near + 0.5 * (c0 - far))

    rbse, rbnw = diag_est(1, 1), diag_est(-1, -1)
    rbne, rbsw = diag_est(-1, 1), diag_est(1, -1)

    dp = PaddedView(delp, 2, mode="reflect")
    dm = PaddedView(delm, 2, mode="reflect")
    wtse = EPS + delm + dm.at(1, 1) + dm.at(2, 2)
    wtnw = EPS + delm + dm.at(-1, -1) + dm.at(-2, -2)
    wtne = EPS + delp + dp.at(-1, 1) + dp.at(-2, 2)
    wtsw = EPS + delp + dp.at(1, -1) + dp.at(2, -2)
    rbm_ = (wtse * rbnw + wtnw * rbse) / (wtse + wtnw)
    rbp_ = (wtne * rbsw + wtsw * rbne) / (wtne + wtsw)
    del dp, dm, delp, delm, wtse, wtnw, wtne, wtsw
    del rbse, rbnw, rbne, rbsw

    q1p = PaddedView(dgrbsq1p, 3, mode="reflect")
    q1m = PaddedView(dgrbsq1m, 3, mode="reflect")

    def diagvar(q):
        return (GAUSSEVEN[0] * (q.at(-1, 0) + q.at(0, -1)
                                + q.at(0, 1) + q.at(1, 0))
                + GAUSSEVEN[1] * (q.at(-2, -1) + q.at(-2, 1)
                                  + q.at(-1, -2) + q.at(-1, 2)
                                  + q.at(1, -2) + q.at(1, 2)
                                  + q.at(2, -1) + q.at(2, 1)))

    rbvarm = EPSSQ + diagvar(q1m)
    pmwt = rbvarm / ((EPSSQ + diagvar(q1p)) + rbvarm)
    del q1p, q1m, dgrbsq1p, dgrbsq1m, rbvarm

    def bound_diag(rb, n1, n2):
        """(:1069-1105): only lowers estimates below the mosaic or above
        the clip."""
        ulim = _ulim(rb, n1, n2)
        w = 2.0 * (c0 - rb) / (EPS + rb + c0)
        low = torch.where(2.0 * rb < c0, ulim, w * rb + (1.0 - w) * ulim)
        rb = torch.where(rb < c0, low, rb)
        return torch.where(rb > clip_pt, ulim, rb)

    rbp_ = bound_diag(rbp_, c.at(-1, 1), c.at(1, -1))
    rbm_ = bound_diag(rbm_, c.at(-1, -1), c.at(1, 1))

    # 9. pmwt escalation (:1113-1119, in place like hvwt's) and rbint
    pmwt = _escalate_rows(pmwt, 10, 10)
    rbint = 0.5 * (c0 + rbm_ * (1.0 - pmwt) + rbp_ * pmwt)
    del rbm_, rbp_

    # 10. G re-interpolated from R+B (:1129-1233)
    ri = PaddedView(rbint, 2, mode="reflect")

    def card_est(nb, far):
        cr = nb * 2.0 / (EPS + rbint + far)
        return torch.where(torch.abs(1.0 - cr) < ARTHRESH, rbint * cr,
                           nb + 0.5 * (rbint - far))

    gu2 = card_est(cN, ri.at(-2, 0))
    gd2 = card_est(cS, ri.at(2, 0))
    gl2 = card_est(cW, ri.at(0, -2))
    gr2 = card_est(cE, ri.at(0, 2))
    del ri
    gintv2 = (d0.at(-1, 0) * gd2 + d0.at(1, 0) * gu2) \
        / (d0.at(1, 0) + d0.at(-1, 0))
    ginth2 = (d1.at(0, -1) * gr2 + d1.at(0, 1) * gl2) \
        / (d1.at(0, -1) + d1.at(0, 1))
    del gu2, gd2, gl2, gr2, d0, d1, dirwts0, dirwts1

    def bound_g2(gint, n1, n2):
        ulim = _ulim(gint, n1, n2)
        w = 2.0 * (rbint - gint) / (EPS + gint + rbint)
        low = torch.where(2.0 * gint < rbint, ulim,
                          w * gint + (1.0 - w) * ulim)
        gint = torch.where(gint < rbint, low, gint)
        return torch.where(gint > clip_pt, ulim, gint)

    gintv2 = bound_g2(gintv2, cN, cS)
    ginth2 = bound_g2(ginth2, cW, cE)
    g_diag = ginth2 * (1.0 - hvwt) + gintv2 * hvwt
    use_diag = (torch.abs(0.5 - pmwt) >= torch.abs(0.5 - hvwt)) & rb_mask
    rgbgreen = torch.where(use_diag, g_diag, rgbgreen)
    dgrb0 = torch.where(use_diag, rgbgreen - c0, dgrb0)
    del gintv2, ginth2, g_diag, use_diag, rbint, pmwt

    # 11. the diagonal chrominance interpolation (:1237-1276): dgrb0 =
    # G-R (valid at R), dgrb1 = G-B (valid at B)
    dgrb1 = torch.where(bmask > 0, dgrb0, 0.0)
    dgrb0 = torch.where(rmask > 0, dgrb0, 0.0)

    def fancy(dsrc):
        """A colour difference at the opposite coset from its 4 diagonal
        neighbours (all on the source coset)."""
        d = PaddedView(dsrc, 5, mode="reflect")
        nw1, ne1 = d.at(-1, -1), d.at(-1, 1)
        sw1, se1 = d.at(1, -1), d.at(1, 1)
        nw3, ne3 = d.at(-3, -3), d.at(-3, 3)
        sw3, se3 = d.at(3, -3), d.at(3, 3)
        wtnw = 1.0 / (EPS + torch.abs(nw1 - se1) + torch.abs(nw1 - nw3)
                      + torch.abs(se1 - nw3))
        wtne = 1.0 / (EPS + torch.abs(ne1 - sw1) + torch.abs(ne1 - ne3)
                      + torch.abs(sw1 - ne3))
        # the sw/se arms cross-reference the opposite far taps (amaze.cc
        # :1256-1261), kept as the JAX package keeps them
        wtsw = 1.0 / (EPS + torch.abs(sw1 - ne1) + torch.abs(sw1 - se3)
                      + torch.abs(ne1 - sw3))
        wtse = 1.0 / (EPS + torch.abs(se1 - nw1) + torch.abs(se1 - sw3)
                      + torch.abs(nw1 - se3))
        # the reference's NE/SW 4th taps are (indx+p1+v2)>>1 and
        # (indx-p1-v2)>>1: the 1-away SE/NW neighbours (p1+v2 == m1)
        return (wtnw * (1.325 * nw1 - 0.175 * nw3
                        - 0.075 * d.at(-1, -3) - 0.075 * d.at(-3, -1))
                + wtne * (1.325 * ne1 - 0.175 * ne3
                          - 0.075 * d.at(-1, 3) - 0.075 * se1)
                + wtsw * (1.325 * sw1 - 0.175 * sw3
                          - 0.075 * d.at(1, -3) - 0.075 * nw1)
                + wtse * (1.325 * se1 - 0.175 * se3
                          - 0.075 * d.at(1, 3) - 0.075 * d.at(3, 1))) \
            / (wtnw + wtne + wtsw + wtse)

    dgrb1 = torch.where(rmask > 0, fancy(dgrb1), dgrb1)   # G-B at R sites
    dgrb0 = torch.where(bmask > 0, fancy(dgrb0), dgrb0)   # G-R at B sites

    # 12. R/B at G sites (:1278-1410)
    hwp = PaddedView(hvwt, 1, mode="reflect")
    wN, wS = hwp.at(-1, 0), hwp.at(1, 0)
    wE, wW = hwp.at(0, 1), hwp.at(0, -1)
    temp = 1.0 / (wN + 2.0 - wE - wW + wS)

    def at_green(dsrc):
        d = PaddedView(dsrc, 1, mode="reflect")
        return (wN * d.at(-1, 0) + (1.0 - wE) * d.at(0, 1)
                + (1.0 - wW) * d.at(0, -1) + wS * d.at(1, 0)) * temp

    R = torch.where(gmask, rgbgreen - at_green(dgrb0), rgbgreen - dgrb0)
    B = torch.where(gmask, rgbgreen - at_green(dgrb1), rgbgreen - dgrb1)

    out = torch.stack([R, rgbgreen, B])
    out = torch.clamp(torch.nan_to_num(out, nan=0.5 * clip_pt), 0.0, 1.0)
    if scaler is not None:
        out = out * torch.as_tensor(scaler, dtype=dt, device=out.device)
    return out
