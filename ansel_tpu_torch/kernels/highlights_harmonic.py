"""The HARMONIC highlight mode's all-clip core: a biharmonic luminance
dome times a diffused chromaticity (`ansel_tpu/kernels/
highlights_harmonic.py` in torch).

Behavioural reference: `ansel/src/iop/highlights/segmentation.c`,
`highlights/dome.c:_biharmonic_dome` and `highlights/region.c` steps
7-8.  The JAX package reformulates the per-region sparse solves as one
masked iterative solve over the whole coarse grid: Dirichlet data at
every valid cell decouples the holes as the flood-fill regions are
decoupled.  Per channel, a biharmonic dome fills the channel's own clip
hole coarse to fine (conjugate gradients on the clamped-border 13-point
operator Lap(Lap), after a harmonic seed); in the cells where all three
clip, each chromaticity c/L is re-diffused from the rim with the
structure-steered Weickert stencil over the dome luminance, the
saturation floor projected every sweep; the result is upsampled,
remosaiced with the floor max(rec, clip) and composited through the
feathered clip mask.

Plain torch, as XLA on the TPU.  The `lax.scan`s are Python loops; the
CG scalars (`rs`, `alpha`, `beta`) stay 0-d tensors on the device, so no
iteration reads back to the host.  `jax.image.resize(..., "bilinear")`
antialiases when it shrinks: `pixel/resample.resize_bilinear` follows its
weights (`F.interpolate` does not).
"""

from __future__ import annotations

import math

import torch

from ..core.types import CFAPattern
from ..ops import _bayer
from ..pixel.resample import resize_bilinear
from ..pixel.shifts import PaddedView, pad_tail
from .highlights_laplacian import _interpolate_and_mask

DS_FACTOR = 4          # working resolution of the dome pyramid base
COARSEST = 24          # stop the pyramid when max(h, w) <= this


def _lap5(u):
    """Clamped-border 5-point Laplacian (the factor of the reference's
    13-point stencil, dome.c:101-107)."""
    p = PaddedView(u, 1)
    return (p.at(-1, 0) + p.at(1, 0) + p.at(0, -1) + p.at(0, 1)) - 4.0 * u


def _down2(x):
    """2x2 means, the last row and column repeated on an odd side."""
    h, w = x.shape[-2:]
    x = pad_tail(x, (-h) % 2, (-w) % 2)
    h2, w2 = x.shape[-2] // 2, x.shape[-1] // 2
    return x.reshape(*x.shape[:-2], h2, 2, w2, 2).mean(dim=(-3, -1))


def _up2(x, h, w):
    return resize_bilinear(x, (*x.shape[:-2], h, w))


def _masked_cg(u, fixed, hole, iters, biharmonic):
    """Conjugate gradients on A = P_h L P_h (P_h the restriction to the
    hole cells; L = Lap(Lap) with clamped borders, or -Lap for the
    harmonic fills), the valid cells fixed: `iters` iterations, every
    scalar a 0-d device tensor."""
    hf = hole.to(u.dtype)

    def L(v):
        return _lap5(_lap5(v)) if biharmonic else -_lap5(v)

    u0 = torch.where(hole, u, fixed)
    b = -hf * L(u0)
    x = torch.zeros_like(u0)
    r = b
    p = r
    rs = torch.sum(r * r)
    for _ in range(iters):
        Ap = hf * L(hf * p)
        alpha = rs / torch.clamp(torch.sum(p * Ap), min=1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = torch.sum(r * r)
        beta = rs_new / torch.clamp(rs, min=1e-30)
        p = r + beta * p
        rs = rs_new
    return torch.where(hole, u0 + x, fixed)


def _masked_laplace(u, fixed, hole, iters):
    """Harmonic fill (Lap u = 0 on the holes)."""
    return _masked_cg(u, fixed, hole, iters, biharmonic=False)


def _masked_biharmonic(u, fixed, hole, iters):
    """Biharmonic dome (Lap(Lap) u = 0 on the holes): the rim's value and
    gradient carried in, the energy-recovering solve of dome.c."""
    return _masked_cg(u, fixed, hole, iters, biharmonic=True)


def _box3(p):
    pv = PaddedView(p, 1)
    row = (pv.at(-1, 0) + p + pv.at(1, 0)) / 3.0
    pr = PaddedView(row, 1)
    return (pr.at(0, -1) + row + pr.at(0, 1)) / 3.0


def _adaptive_tensor(steer, k=0.15):
    """The variance-adaptive steering tensor from the guide plane
    (coefficient_field.c:_cf_adaptive_tensor):

      D = [m + (1-m) c2] t t^T + [m c2 + (1-m)] g g^T
      c2 = exp(-|grad Lb| / (4 <|grad Lb|>))
      m  = v / (v + (k Lb)^2),  v = max(var_w(Lb) - 4/3 |grad Lb|^2, 0)

    Lb the twice 3x3-box-blurred guide, g its unit gradient, t the unit
    isophote.  -> (Dxx, Dxy, Dyy)."""
    lb = _box3(_box3(steer))
    qb = _box3(_box3(steer * steer))
    p = PaddedView(lb, 1)
    gx = 0.5 * (p.at(0, 1) - p.at(0, -1))
    gy = 0.5 * (p.at(1, 0) - p.at(-1, 0))
    gmag = torch.sqrt(gx * gx + gy * gy)
    gmean = torch.clamp(torch.mean(gmag), min=1e-9)
    nonzero = (gmag > 1e-12).to(steer.dtype)
    inv = nonzero / (gmag + (1.0 - nonzero))
    gux = gx * inv + (1.0 - nonzero)
    guy = gy * inv
    tx, ty = -guy, gux
    c2 = torch.exp(-gmag / (4.0 * gmean))
    var = torch.clamp(qb - lb * lb, min=0.0)
    vres = torch.clamp(var - (4.0 / 3.0) * (gx * gx + gy * gy), min=0.0)
    kterm = (k * torch.clamp(lb, min=1e-9)) ** 2
    m = vres / (vres + kterm + 1e-18)
    dt_ = m + (1.0 - m) * c2
    dg = m * c2 + (1.0 - m)
    dxx = dt_ * tx * tx + dg * gux * gux
    dxy = dt_ * tx * ty + dg * gux * guy
    dyy = dt_ * ty * ty + dg * guy * guy
    return dxx, dxy, dyy


_OFFS = ((0, -1), (0, 1), (-1, 0), (1, 0), (-1, -1), (1, 1), (-1, 1),
         (1, -1))


def _masked_aniso_laplace(u, fixed, hole, steer, iters, obstacle=None):
    """Structure-steered harmonic fill: div(D grad u) = 0 on the holes
    (region.c step 8, chroma.h), Jacobi sweeps through the Weickert
    nonnegativity stencil (per edge the tensor averaged across it, the
    cross term clamped to +-min(a, c)); with `obstacle`, every sweep
    projects u = max(u, obstacle)."""
    dxx, dxy, dyy = _adaptive_tensor(steer)
    pxx = PaddedView(dxx, 1)
    pxy = PaddedView(dxy, 1)
    pyy = PaddedView(dyy, 1)

    ws = []
    for (dy, dx) in _OFFS:
        axx = 0.5 * (dxx + pxx.at(dy, dx))
        ayy = 0.5 * (dyy + pyy.at(dy, dx))
        limit = torch.minimum(axx, ayy)
        cross = torch.clamp(0.5 * (dxy + pxy.at(dy, dx)), -limit, limit)
        if dy == 0:
            w = torch.clamp(axx - torch.abs(cross), min=1e-4)
        elif dx == 0:
            w = torch.clamp(ayy - torch.abs(cross), min=1e-4)
        elif dx == dy:
            w = torch.clamp(cross, min=0.0)
        else:
            w = torch.clamp(-cross, min=0.0)
        ws.append(w)
    wsum = torch.clamp(sum(ws), min=1e-12)

    v = torch.where(hole, u, fixed)
    for _ in range(iters):
        pv = PaddedView(v, 1)
        acc = sum(w * pv.at(dy, dx) for w, (dy, dx) in zip(ws, _OFFS))
        upd = acc / wsum
        if obstacle is not None:
            upd = torch.maximum(upd, obstacle)
        v = torch.where(hole, upd, v)
    return torch.where(hole, v, fixed)


def _solve_pyramid(field, valid, hole, nlev, lap_iters=40, bih_iters=80,
                   biharmonic=True, steer=None, obstacle=None):
    """Coarse-to-fine masked solve of `field` (garbage in the hole) over
    `nlev` halvings: the coarsest level seeded with the valid mean,
    harmonic-filled, then domed; each finer level from the upsampled
    coarser solution.  With `steer`, the harmonic fills are the steered
    sweeps on each level's downsampled guide; `obstacle` the per-sweep
    floor."""
    fields, valids, holes = [field], [valid], [hole]
    steers, obss = [steer], [obstacle]
    for _ in range(nlev):
        v2 = _down2(valids[-1])
        f2 = _down2(fields[-1] * valids[-1]) / torch.clamp(v2, min=1e-6)
        # a coarse cell is a hole if most of its support is (dome.c:90)
        h2 = v2 < 0.5
        fields.append(torch.where(h2, 0.0, f2))
        valids.append(torch.where(h2, 0.0, 1.0))
        holes.append(h2)
        steers.append(_down2(steers[-1]) if steer is not None else None)
        obss.append(_down2(obss[-1]) if obstacle is not None else None)

    def hfill(u, fixed, hl, iters, lev):
        if steer is not None:
            return _masked_aniso_laplace(u, fixed, hl, steers[lev], iters,
                                         obstacle=obss[lev])
        return _masked_laplace(u, fixed, hl, iters)

    # the coarsest level: holes seeded with the valid mean (dome.c:286-301)
    fL, hL = fields[-1], holes[-1]
    vL = 1.0 - hL.to(fL.dtype)
    mean = torch.sum(fL * vL) / torch.clamp(torch.sum(vL), min=1.0)
    u = torch.where(hL, mean, fL)
    u = hfill(u, fL, hL, lap_iters, nlev)
    if biharmonic:
        u = _masked_biharmonic(u, fL, hL, bih_iters)

    for lev in range(nlev - 1, -1, -1):
        h, w = fields[lev].shape
        init = torch.where(holes[lev], _up2(u, h, w), fields[lev])
        u = hfill(init, fields[lev], holes[lev], lap_iters // 2, lev)
        if biharmonic:
            u = _masked_biharmonic(u, fields[lev], holes[lev], bih_iters)
    return u


def pyramid_levels(dsh: int, dsw: int) -> int:
    """The halvings of the dome pyramid on a (dsh, dsw) base."""
    big = max(dsh, dsw)
    return max(int(math.ceil(math.log2(big / COARSEST)))
               if big > COARSEST else 0, 0)


def harmonic_dome_core(x, rec, clips, cfa: CFAPattern):
    """Per-channel biharmonic domes and the all-clip chroma coherence on
    a Bayer mosaic.  x: (H, W) the mosaic; rec: the mosaic after the
    guided-Laplacian pass (the rim estimates); clips: per-channel clip
    thresholds.  The clip masks come from `x`, the values from `rec`."""
    h, w = x.shape
    dev, dt = x.device, x.dtype
    clips = [torch.as_tensor(clips[i], dtype=dt, device=dev)
             for i in range(3)]
    norm = [torch.ones((), dtype=dt, device=dev)] * 3 \
        + [torch.tensor(math.sqrt(3.0), dtype=dt, device=dev)]
    _, mask = _interpolate_and_mask(x, clips, norm, cfa)
    interp, _ = _interpolate_and_mask(rec, clips, norm, cfa)

    # the working resolution: the Laplacian path's 1/4 base, shared by
    # the channels as dome.c:44-49 shares it
    dsh, dsw = max(h // DS_FACTOR, 8), max(w // DS_FACTOR, 8)
    planes = resize_bilinear(interp[:3].contiguous(), (3, dsh, dsw))
    maskds = resize_bilinear(mask[:3].contiguous(), (3, dsh, dsw))
    del interp, mask
    nlev = pyramid_levels(dsh, dsw)

    # per-channel domes on each channel's own hole (_selfdome)
    domes = []
    for c in range(3):
        hole_c = maskds[c] > 0.5
        validf = 1.0 - hole_c.to(dt)
        domes.append(_solve_pyramid(
            torch.where(hole_c, 0.0, planes[c]), validf, hole_c, nlev))
    domes = torch.stack(domes)

    # the all-clip core: chromaticity re-diffused from the rim over the
    # dome luminance, steered by it, floored at clip / L every sweep
    hole_all = (maskds[0] > 0.5) & (maskds[1] > 0.5) & (maskds[2] > 0.5)
    valid_all = 1.0 - hole_all.to(dt)
    L_dome = (domes[0] + domes[1] + domes[2]) / 3.0
    Lsafe = torch.clamp(L_dome, min=1e-6)
    ratios = torch.stack([
        _solve_pyramid(torch.where(hole_all, 0.0, domes[c] / Lsafe),
                       valid_all, hole_all, nlev, biharmonic=False,
                       lap_iters=100, steer=L_dome,
                       obstacle=clips[c] / Lsafe)
        for c in range(3)])
    rec_planes = torch.where(hole_all[None], ratios * Lsafe, domes)
    rec_full = resize_bilinear(rec_planes, (3, h, w))
    del ratios, rec_planes, domes

    # remosaic: each site's reconstructed value floored at the rim
    # estimate (region.c:73-77), composited through the feathered clip
    # mask (a 5x5 box, segmentation.c:52-56)
    rmaskf, gmaskf, bmaskf = _bayer.color_masks(cfa, h, w, dev)
    site_rec = (rec_full[0] * rmaskf + rec_full[1] * gmaskf
                + rec_full[2] * bmaskf)
    site_rec = torch.maximum(site_rec, rec)
    site_clip = clips[0] * rmaskf + clips[1] * gmaskf + clips[2] * bmaskf
    m = (x > site_clip).to(dt)
    p = PaddedView(m, 2)
    row = sum(p.at(k, 0) for k in range(-2, 3)) / 5.0
    pr = PaddedView(row, 2)
    opacity = torch.clamp(sum(pr.at(0, k) for k in range(-2, 3)) / 5.0,
                          0.0, 1.0)
    return opacity * site_rec + (1.0 - opacity) * rec
