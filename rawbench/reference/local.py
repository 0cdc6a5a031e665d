"""Spatial stages of the plain reference on (3, H, W) float32 tensors:
tone equalizer (its exposure-independent guided mask), diffuse or sharpen
(anisotropic diffusion on B-spline wavelet scales) and local contrast
(the local Laplacian filter).

Written from darktable/ansel's published algorithms (src/iop/
toneequal.c with src/pixel/eigf.h and the Deriche recursive Gaussian of
src/pixel/gaussian.c; src/iop/diffuse.c; src/pixel/locallaplacian.c,
Paris, Hasinoff and Kautz's fast local Laplacian with six remap
samples) at the program's float32 conventions, and frozen here.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _pad_edge(x, m):
    lead = x.shape[:-2]
    p = F.pad(x.reshape((-1,) + tuple(x.shape[-2:]))[None], (m,) * 4,
              mode="replicate")[0]
    return p.reshape(tuple(lead) + tuple(p.shape[-2:]))


def sep_blur(x, taps, dilation=1):
    """Edge-padded separable FIR: the vertical pass, then the
    horizontal, each summed in tap order."""
    r = (len(taps) - 1) // 2
    m = r * dilation
    h, w = x.shape[-2:]
    p = _pad_edge(x, m)
    v = sum(t * p[..., i * dilation:i * dilation + h, m:m + w]
            for i, t in enumerate(taps))
    p = _pad_edge(v, m)
    return sum(t * p[..., m:m + h, j * dilation:j * dilation + w]
               for j, t in enumerate(taps))


# --- tone equalizer ---------------------------------------------------------

TONEEQ_DEFAULTS = {"noise": 0.0, "ultra_deep_blacks": 0.0,
                   "deep_blacks": 0.0, "blacks": 0.0, "shadows": 0.0,
                   "midtones": 0.0, "highlights": 0.0, "whites": 0.0,
                   "speculars": 0.0, "blending": 5.0,
                   "smoothing": math.sqrt(2.0), "feathering": 1.0,
                   "quantization": 0.0, "contrast_boost": 0.0,
                   "exposure_boost": 0.0, "details": 4, "method": 4,
                   "iterations": 1}
ZONES = ("noise", "ultra_deep_blacks", "deep_blacks", "blacks", "shadows",
         "midtones", "highlights", "whites", "speculars")


def _deriche(sigma):
    """Deriche's order-0 coefficients (a0, a1, a2, a3, b1, b2, coefp,
    coefn) as float32 values."""
    alpha = 1.695 / sigma
    ema, ema2 = math.exp(-alpha), math.exp(-2.0 * alpha)
    b1, b2 = -2.0 * ema, ema2
    k = (1.0 - ema) ** 2 / (1.0 + 2.0 * alpha * ema - ema2)
    a0, a1, a2, a3 = k, k * (alpha - 1.0) * ema, k * (alpha + 1.0) * ema, \
        -k * ema2
    coefs = (a0, a1, a2, a3, b1, b2, (a0 + a1) / (1.0 + b1 + b2),
             (a2 + a3) / (1.0 + b1 + b2))
    return tuple(float(np.float32(c)) for c in coefs)


def _recursion(v, coef):
    """Forward plus backward recursion down axis -2 of (N, H, W); the
    backward one starts from the end padded to a multiple of 8 rows with
    the last row repeated, primed with coefn times it."""
    a0, a1, a2, a3, b1, b2, coefp, coefn = coef
    h = v.shape[-2]
    x0 = v[:, 0]
    xprev, y1 = x0, coefp * x0
    y2 = y1
    ys = []
    for i in range(h):
        xr = v[:, i]
        y = (a0 * xr + a1 * xprev) - b1 * y1 - b2 * y2
        ys.append(y)
        xprev, y2, y1 = xr, y1, y
    xlast = v[:, h - 1]
    xn1 = xn2 = xlast
    z1 = coefn * xlast
    z2 = z1
    out = [None] * h
    for r in range(-(-h // 8) * 8 - 1, -1, -1):
        z = (a2 * xn1 + a3 * xn2) - b1 * z1 - b2 * z2
        if r < h:
            out[r] = ys[r] + z
        xn2, xn1 = xn1, v[:, min(r, h - 1)]
        z2, z1 = z1, z
    return torch.stack(out, dim=1)


def gaussian_iir(x, sigma):
    """Deriche recursive Gaussian of (..., H, W): columns, then rows."""
    coef = _deriche(sigma)
    v = x.reshape((-1,) + tuple(x.shape[-2:]))
    v = _recursion(v, coef)
    v = _recursion(v.transpose(-1, -2), coef).transpose(-1, -2)
    return v.contiguous().reshape(x.shape)


def _resample_nodes(x, out_h, out_w):
    """Node-aligned bilinear resampling by integer factors: decimation
    down, phase interpolation up."""
    in_h, in_w = x.shape[-2:]
    if (in_h, in_w) == (out_h, out_w):
        return x
    if in_h % out_h == 0 and in_w % out_w == 0 and in_h >= out_h:
        return x[..., ::in_h // out_h, ::in_w // out_w]
    if out_h % in_h or out_w % in_w:
        raise NotImplementedError("only integer resampling factors")

    def up(a, s, axis):
        n = a.shape[axis]
        nxt = torch.cat([a.narrow(axis, 1, n - 1), a.narrow(axis, n - 1, 1)],
                        dim=axis)
        st = torch.stack([(1.0 - p / s) * a + (p / s) * nxt
                          for p in range(s)], dim=axis + 1 if axis >= 0
                         else a.dim() + axis + 1)
        shape = list(a.shape)
        shape[axis] *= s
        return st.reshape(shape)

    return up(up(x, out_h // in_h, -2), out_w // in_w, -1)


def toneequal(x, p, width, height):
    """Exposure-weighted gains from nine zone sliders, applied through an
    edge-aware mask of the pixel norm (eigf surface blur, sigma = the
    blending share of the frame's larger side, at a 4x downsample)."""
    q = dict(TONEEQ_DEFAULTS, **p)
    if (q["details"], q["method"], q["iterations"], q["quantization"]) != (
            4, 4, 1, 0.0):
        raise NotImplementedError("toneequal: only the eigf mask on the "
                                  "pixel's 2-norm is written")
    centres_p = np.linspace(-8.0, 0.0, 9)
    centres = np.linspace(-8.0, 0.0, 8)
    gains = np.exp2([q[z] for z in ZONES])
    denom = 2.0 * q["smoothing"] ** 2
    A = np.exp(-((centres_p[:, None] - centres[None, :]) ** 2) / denom)
    factors = np.linalg.lstsq(A, gains, rcond=None)[0].astype(np.float32)
    fulcrum = 2.0 ** -4
    eb = float(np.float32(2.0 ** q["exposure_boost"]))
    cb = float(np.float32(2.0 ** q["contrast_boost"]))
    feather = float(np.float32(1.0 / q["feathering"]))
    denom = float(np.float32(denom))

    lum = torch.sqrt(x[0] * x[0] + x[1] * x[1] + x[2] * x[2])
    lum = torch.clamp((eb * lum - fulcrum) * cb + fulcrum, min=2.0 ** -16)

    sigma = float(max(1, int(round(q["blending"] / 100.0
                                   * max(width, height)))))
    H, W = lum.shape
    scaling = min(max(sigma, 1.0), 4.0)
    dh, dw = max(int(H / scaling), 1), max(int(W / scaling), 1)
    ds = _resample_nodes(lum, dh, dw)
    blurred = gaussian_iir(torch.stack([ds, ds * ds]),
                           max(sigma / scaling, 1.0))
    avg = blurred[0]
    var = torch.clamp(blurred[1] - avg * avg, min=0.0)
    avg = _resample_nodes(avg, H, W)
    var = _resample_nodes(var, H, W)
    nvar = var / torch.clamp(avg * lum, min=1e-6)
    a = nvar / (nvar + feather)
    mask = torch.clamp(lum * a + (avg - a * avg), min=1.17549435e-38)
    mask = torch.clamp(mask, min=2.0 ** -16)

    ev = torch.clamp(torch.log2(mask), -8.0, 0.0)
    corr = None
    for k, c in enumerate(centres):
        band = torch.exp(-((ev - float(c)) ** 2) / denom) * float(factors[k])
        corr = band if corr is None else corr + band
    return x * torch.clamp(corr, 0.25, 4.0)[None]


# --- diffuse or sharpen -----------------------------------------------------

B3 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)
B_SPLINE_SIGMA = 1.0553651328015339
FLT_MIN = 1e-8


def _scales(final_radius):
    s, radius = 0, B_SPLINE_SIGMA
    while radius < final_radius:
        s += 1
        radius = math.sqrt(radius ** 2 + ((1 << s) * B_SPLINE_SIGMA) ** 2)
    return max(1, min(s + 1, 10))


def _sigma_at(s):
    sig = B_SPLINE_SIGMA
    for i in range(1, s + 1):
        sig = math.sqrt(sig ** 2 + ((1 << i) * B_SPLINE_SIGMA) ** 2)
    return sig


def _sh(a, dy, dx):
    return torch.roll(a, (-dy, -dx), (-2, -1))


def diffuse(x, p):
    """`iterations` of: an a-trous B3 decompose into scales, then from the
    coarsest scale down, each scale's high frequencies and the coarser
    image updated by the four isotropic second-derivative terms, weighted
    per scale, over the local variance; on the image edge-padded once by
    the iteration's reach."""
    iters = int(p.get("iterations", 1))
    aniso = [p.get(k, 0.0) for k in ("anisotropy_first", "anisotropy_second",
                                     "anisotropy_third",
                                     "anisotropy_fourth")]
    if any(a != 0.0 for a in aniso) or p.get("threshold", 0.0) > 0.0:
        raise NotImplementedError("diffuse: only isotropic diffusion "
                                  "without a threshold is written")
    radius, centre = float(p.get("radius", 8)), float(p.get("radius_center",
                                                            0))
    scales = _scales((radius + centre) * 2.0)
    if scales > 5:
        raise NotImplementedError("diffuse: at most 5 scales are written")
    reg = 10.0 ** p.get("regularization", 0.0) - 1.0
    vt = float(np.float32(10.0 ** p.get("variance_threshold", 0.0)))
    speeds = np.float32([p.get(k, 0.0) for k in ("first", "second", "third",
                                                 "fourth")])
    abcd, strength, norm_reg = [], [], []
    for s in range(scales):
        real = _sigma_at(s)
        norm = math.exp(-((real - centre) ** 2) / max(radius, 1e-6) ** 2)
        abcd.append((speeds * 0.25 * norm).astype(np.float32).tolist())
        strength.append(float(np.float32(p.get("sharpness", 0.0) * norm
                                         + 1.0)))
        norm_reg.append(float(np.float32(reg / 9.0 * real ** 2)))

    m = 3 * ((1 << scales) - 1)
    h, w = x.shape[-2:]
    out = x
    for _ in range(iters):
        cur = _pad_edge(out, m)
        hf = []
        for s in range(scales):
            d = 1 << s
            row = sum(B3[k] * _sh(cur, (k - 2) * d, 0) for k in range(5))
            low = sum(B3[k] * _sh(row, 0, (k - 2) * d) for k in range(5))
            hf.append(cur - low)
            cur = low
        buf = cur
        for s in range(scales - 1, -1, -1):
            d = 1 << s
            q = (hf[s] * (1.0 / (torch.clamp(buf - FLT_MIN, min=0.0)
                                 + FLT_MIN))) ** 2
            rq = _sh(q, 0, -d) + q + _sh(q, 0, d)
            box = _sh(rq, -d, 0) + rq + _sh(rq, d, 0)
            energy = torch.clamp(vt + box * norm_reg[s] - FLT_MIN,
                                 min=0.0) + FLT_MIN
            update = None
            for k, src in enumerate((buf, buf, hf[s], hf[s])):
                rowp = 0.5 * (_sh(src, 0, -d) + _sh(src, 0, d)) + src
                lap = (0.5 * (_sh(rowp, -d, 0) + _sh(rowp, d, 0))
                       + rowp - 4.0 * src)
                term = abcd[s][k] * lap
                update = term if update is None else update + term
            acc = hf[s] * strength[s] + update * (1.0 / energy)
            buf = torch.clamp(acc + buf, min=0.0)
        out = buf[:, m:m + h, m:m + w].contiguous()
    return out


# --- local contrast: the local Laplacian filter -----------------------------

K5 = [float(v) for v in np.float32([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0]


def _reduce(x):
    return sep_blur(x, K5)[..., ::2, ::2]


def _expand(x, shape):
    h, w = shape
    x = x[..., :(h + 1) // 2, :(w + 1) // 2]
    up = x.new_zeros(tuple(x.shape[:-2]) + (2 * x.shape[-2],
                                            2 * x.shape[-1]))
    up[..., ::2, ::2] = x
    return sep_blur(up[..., :h, :w], K5) * 4.0


def _remap(x, g, sigma, shadows, highlights, clarity):
    g_hi = float(np.float32(g) + np.float32(sigma))
    g_lo = float(np.float32(g) - np.float32(sigma))
    c = x - g
    t_s = torch.clamp(c / (2.0 * sigma), 0.0, 1.0)
    t_h = torch.clamp(-c / (2.0 * sigma), 0.0, 1.0)
    shadow = g + sigma * 2.0 * (1.0 - t_s) * t_s \
        + t_s * t_s * (sigma + sigma * shadows)
    highlight = g - sigma * 2.0 * (1.0 - t_h) * t_h \
        + t_h * t_h * (-sigma - sigma * highlights)
    val = torch.where(c > 2.0 * sigma, g_hi + shadows * (c - sigma),
                      torch.where(c < -2.0 * sigma,
                                  g_lo + highlights * (c + sigma),
                                  torch.where(c > 0.0, shadow, highlight)))
    return val + clarity * c * torch.exp(-c * c / (2.0 * sigma * sigma / 3.0))


def local_laplacian(L, sigma, shadows, highlights, clarity):
    h, w = L.shape
    levels = max(2, min(10, int(math.log2(max(min(h, w), 4))) - 1))
    gpyr = [L]
    for _ in range(levels - 1):
        gpyr.append(_reduce(gpyr[-1]))
    step = 1.0 / 6
    idx = [torch.clamp((g - 0.5 * step) / step, 0.0, 5.0) for g in gpyr[:-1]]
    acc = [torch.zeros_like(g) for g in gpyr[:-1]]
    for k in range(6):
        g = float(np.float32((k + 0.5) / 6))
        pyr = [_remap(L, g, sigma, shadows, highlights, clarity)]
        for _ in range(levels - 1):
            pyr.append(_reduce(pyr[-1]))
        for lv in range(levels - 1):
            lap = pyr[lv] - _expand(pyr[lv + 1], pyr[lv].shape)
            wk = torch.clamp(1.0 - torch.abs(idx[lv] - float(k)), min=0.0)
            acc[lv] = acc[lv] + wk * lap
    out = gpyr[-1]
    for lv in range(levels - 2, -1, -1):
        out = _expand(out, gpyr[lv].shape) + acc[lv]
    return out


def bilat(lab, p):
    """Local contrast in its local Laplacian mode on L."""
    if p.get("mode", 1) != 1:
        raise NotImplementedError("bilat: only the local Laplacian mode")
    L = local_laplacian(lab[0] / 100.0, round(max(p.get("midtone", 0.5),
                                                  1e-3), 5),
                        round(p.get("sigma_s", 0.5), 4) / 100.0,
                        round(p.get("sigma_r", 0.5), 4) / 100.0,
                        round(p.get("detail", 0.25), 4))
    return torch.stack([torch.clamp(L * 100.0, min=0.0), lab[1], lab[2]])
