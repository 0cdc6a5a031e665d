"""Guided-Laplacian highlight reconstruction on a Bayer mosaic.

Port of `ansel_tpu/kernels/highlights_laplacian.py` (reference
`src/iop/highlights/laplacian.c` process_laplacian :433-575 and
`highlights/gather.c` :67-485): gather and normalise, 4x downsample,
iterations x [guided RGB pass + ratio-diffusion pass] over an a-trous
B-spline pyramid, upsample, remosaic.

Plain torch, like the JAX package's XLA code, except the pyramid's blur:
`_sep_blur4` goes through `pixel/shifts.sep_filter`, which runs the
sepblur kernel on the device (30 iterations x 2 passes x 6 scales = 360
launches per 24 MP image).  `lax.scan` becomes a Python loop.  Per-channel
loops of the JAX code run as one operation over the channel axis where
each element sees the same float32 operations in the same order.

The Poisson salt of the last iteration (noise_level > 0) draws JAX's
generator's normal bits (`pixel/prng`, the last key of
split(PRNGKey(0x411E), iterations)), as the JAX package draws them.
"""

from __future__ import annotations

import math

import torch

from ..core.types import CFAPattern
from ..ops import _bayer
from ..pixel import prng
from ..pixel.resample import resize_bilinear
from ..pixel.shifts import PaddedView, sep_filter

DS_FACTOR = 4
B_SPLINE_SIGMA = 1.0553651328015339
B_SPLINE_TO_LAPLACIAN = 3.182727439285017
MAX_NUM_SCALES = 10
_B3 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)

FIRST_SCALE = 1
LAST_SCALE = 2
SALT_SEED = 0x411E


def _sep_blur4(x4, mult):
    """B3 a-trous blur of a (4, H, W) stack at dilation mult."""
    return sep_filter(x4, _B3, mult)


def _interpolate_and_mask(x, clips, norm, cfa: CFAPattern):
    """Bilinear CFA fill to [R, G, B, norm] + binary clip masks
    (gather.c:67-220).  Borders mirror (reflection keeps the CFA phase)."""
    h, w = x.shape
    p = PaddedView(x, 1, mode="reflect")
    N, S, W_, E = p.at(-1, 0), p.at(1, 0), p.at(0, -1), p.at(0, 1)
    NW, NE, SW, SE = p.at(-1, -1), p.at(-1, 1), p.at(1, -1), p.at(1, 1)

    rmask, gmask, bmask = _bayer.color_masks(cfa, h, w, x.device).bool()
    # green sites on red rows have horizontal R neighbours
    red_row_parity = 0 if 0 in (cfa.color_at(0, 0), cfa.color_at(0, 1)) \
        else 1
    rp, _ = _bayer.parity_maps(h, w, device=x.device)
    rrow = (rp == red_row_parity).expand(h, w)

    cross4 = (N + S + W_ + E) * 0.25
    diag4 = (NW + NE + SW + SE) * 0.25
    horiz = (W_ + E) * 0.5
    vert = (N + S) * 0.5

    def clipped4(a, b, cc, d, t):
        return (a > t) | (b > t) | (cc > t) | (d > t)

    G = torch.where(gmask, x, cross4)
    G_c = torch.where(gmask, x > clips[1], clipped4(N, S, W_, E, clips[1]))
    # R: own site / horizontal (G on R-row) / vertical (G on B-row) /
    # diagonal (B site)
    R = torch.where(rmask, x,
                    torch.where(gmask & rrow, horiz,
                                torch.where(gmask, vert, diag4)))
    R_c = torch.where(
        rmask, x > clips[0],
        torch.where(gmask & rrow, (W_ > clips[0]) | (E > clips[0]),
                    torch.where(gmask, (N > clips[0]) | (S > clips[0]),
                                clipped4(NW, NE, SW, SE, clips[0]))))
    B = torch.where(bmask, x,
                    torch.where(gmask & ~rrow, horiz,
                                torch.where(gmask, vert, diag4)))
    B_c = torch.where(
        bmask, x > clips[2],
        torch.where(gmask & ~rrow, (W_ > clips[2]) | (E > clips[2]),
                    torch.where(gmask, (N > clips[2]) | (S > clips[2]),
                                clipped4(NW, NE, SW, SE, clips[2]))))

    Rn = torch.clamp(R / norm[0], min=0.0)
    Gn = torch.clamp(G / norm[1], min=0.0)
    Bn = torch.clamp(B / norm[2], min=0.0)
    mag = torch.sqrt(Rn * Rn + Gn * Gn + Bn * Bn)
    interp = torch.stack([Rn, Gn, Bn, torch.clamp(mag / norm[3], min=0.0)])
    mask = torch.stack([R_c, G_c, B_c, R_c | G_c | B_c]).to(x.dtype)
    return interp, mask


def _pick(g_is_g, g_is_b, v0, v1, v2):
    """The guiding channel's value: argmax variance over R/G/B."""
    return torch.where(g_is_b, v2, torch.where(g_is_g, v1, v0))


def _guide_laplacians(HF, LF, mask, out, mult, radius_sq, stype,
                      noise_level=0.0, key=None):
    """guide_laplacians (laplacian.c:85-248) on (4, h, w) stacks; with a
    `key` and a positive `noise_level`, the last scale adds the Poisson
    salt."""
    pv = PaddedView(HF, mult)
    alpha = mask[3]
    inv_patch = 1.0 / 9.0
    s = s2 = None
    prods = [None] * 3  # (4, h, w) products with guide R, G, B
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            t = pv.at(dy * mult, dx * mult)
            s = t if s is None else s + t
            s2 = t * t if s2 is None else s2 + t * t
            for g in range(3):
                pg = t * t[g]
                prods[g] = pg if prods[g] is None else prods[g] + pg
    means = s * inv_patch
    var = torch.clamp(s2 * inv_patch - means * means, min=0.0)
    g_is_g = var[1] > var[0]
    gv01 = torch.where(g_is_g, var[1], var[0])
    g_is_b = var[2] > gv01
    guide_var = torch.where(g_is_b, var[2], gv01)
    guide_mean = _pick(g_is_g, g_is_b, means[0], means[1], means[2])
    guide_hf = _pick(g_is_g, g_is_b, HF[0], HF[1], HF[2])
    ok = (alpha > 0.0) & (guide_var > 1e-12)
    safe_var = torch.clamp(guide_var, min=1e-12)
    cov = _pick(g_is_g, g_is_b, *prods) * inv_patch - means * guide_mean
    slope = torch.clamp(cov / safe_var, min=0.0)
    intercept = means - slope * guide_mean
    blend = mask / radius_sq
    fitted = blend * (slope * guide_hf + intercept) + (1.0 - blend) * HF
    new_hf = torch.where(ok, fitted, HF)

    out = new_hf if (stype & FIRST_SCALE) else out + new_hf
    if stype & LAST_SCALE:
        out = torch.clamp(out + LF, min=0.0)
        if key is not None and noise_level > 0.0:
            # Poisson-style salt: a half-normal of sigma value * noise
            # (JAX's generator where the reference runs xoshiro)
            g = prng.normal(key, out.shape, out.device)
            noisy = out + torch.abs(g * out * noise_level)
            a = alpha[None]
            out = torch.clamp(a * noisy + (1.0 - a) * out, min=0.0)
        mag = torch.clamp(torch.sqrt(out[0] * out[0] + out[1] * out[1]
                                     + out[2] * out[2]), min=1e-6)
        out = torch.stack([out[0] / mag, out[1] / mag, out[2] / mag, mag])
    return out


def _heat_pde(HF, LF, mask, out, mult, stype, f1):
    """heat_PDE_diffusion (laplacian.c:248-374) on ratios + norm."""
    iso = (0.25, 0.5, 0.25, 0.5, -3.0, 0.5, 0.25, 0.5, 0.25)
    alpha = mask
    hf3 = HF[:3]
    p = PaddedView(hf3, mult)
    lap = None
    for k in range(9):
        term = iso[k] * p.at((k // 3 - 1) * mult, (k % 3 - 1) * mult)
        lap = term if lap is None else lap + term
    upd = hf3 + alpha[:3] * (lap - f1 * hf3) / B_SPLINE_TO_LAPLACIAN
    new_hf = torch.cat([torch.where(alpha[3] > 0.0, upd, hf3), HF[3:]])

    out = new_hf if (stype & FIRST_SCALE) else out + new_hf
    if stype & LAST_SCALE:
        out = torch.clamp(out + LF, min=0.0)
        mag = torch.sqrt(out[0] * out[0] + out[1] * out[1] + out[2] * out[2])
        renorm = (alpha[3] > 0.0) & (mag > 1e-4)
        safe = torch.clamp(mag, min=1e-4)
        ratios = torch.where(renorm, out[:3] / safe, out[:3])
        out = torch.cat([ratios * out[3], out[3:]])
    return out


def _scale_type(s, scales):
    t = 0
    if s == 0:
        t |= FIRST_SCALE
    if s == scales - 1:
        t |= LAST_SCALE
    return t


def _equivalent_sigma(s_eff):
    sig = B_SPLINE_SIGMA
    for i in range(1, s_eff + 1):
        sig = math.sqrt(sig ** 2 + ((1 << i) * B_SPLINE_SIGMA) ** 2)
    return sig


def laplacian_reconstruct(x, clips, cfa: CFAPattern, scales_param: int,
                          iterations: int, noise_level: float,
                          solid_color: float, zoom: float = 1.0):
    """(H, W) Bayer mosaic -> reconstructed mosaic (process_laplacian).
    `clips` holds the R, G, B clip thresholds."""
    h, w = x.shape
    clips = [torch.as_tensor(clips[i], dtype=x.dtype, device=x.device)
             for i in range(3)]

    # per-CFA-color plain averages over the frame (gather.c:224-280);
    # divided by the FULL pixel count so they carry the fill fraction
    rmaskf, gmaskf, bmaskf = _bayer.color_masks(cfa, h, w, x.device)
    n = float(h * w)
    norm = [torch.clamp(torch.sum(x * m) / n, min=1e-6)
            for m in (rmaskf, gmaskf, bmaskf)]
    norm.append(torch.clamp(torch.sqrt(norm[0] * norm[0] + norm[1] * norm[1]
                                       + norm[2] * norm[2]), min=1e-6))

    interp, mask = _interpolate_and_mask(x, clips, norm, cfa)
    # feather the mask: 5x5 box mean (dt_box_mean radius 2)
    p = PaddedView(mask, 2)
    row = sum(p.at(k, 0) for k in range(-2, 3)) / 5.0
    pr = PaddedView(row, 2)
    mask = sum(pr.at(0, k) for k in range(-2, 3)) / 5.0

    dsh, dsw = max(h // DS_FACTOR, 8), max(w // DS_FACTOR, 8)
    ds_interp = resize_bilinear(interp, (4, dsh, dsw))
    ds_mask = resize_bilinear(mask, (4, dsh, dsw))

    eff_scale = DS_FACTOR * max(zoom, 1e-6)
    final_radius = float(1 << max(int(scales_param), 1)) / eff_scale
    scales = min(max(int(math.ceil(math.log2(max(final_radius, 1.0)))), 1),
                 MAX_NUM_SCALES)

    noise = noise_level / eff_scale

    def wavelets_pass(buf, variant_rgb, key=None):
        out = torch.zeros_like(buf)
        cur = buf
        for s in range(scales):
            mult = 1 << s
            lf = _sep_blur4(cur, mult)
            hf = cur - lf
            stype = _scale_type(s, scales)
            if variant_rgb:
                radius_sq = _equivalent_sigma(s * DS_FACTOR) ** 2
                out = _guide_laplacians(hf, lf, ds_mask, out, mult,
                                        radius_sq, stype, noise, key)
            else:
                out = _heat_pde(hf, lf, ds_mask, out, mult, stype,
                                solid_color)
            cur = lf
        return out

    # the salt fires on the last iteration only (laplacian.c:530), with
    # the last of the iterations' keys
    iterations = max(int(iterations), 1)
    salt_key = prng.split(prng.PRNGKey(SALT_SEED), iterations)[-1]
    buf = ds_interp
    for it in range(iterations):
        key = salt_key if it == iterations - 1 else None
        buf = wavelets_pass(wavelets_pass(buf, True, key), False)

    up = resize_bilinear(buf, (4, h, w))
    # remosaic + composite (gather.c:455-485): undo the normalization
    site_norm = rmaskf * norm[0] + gmaskf * norm[1] + bmaskf * norm[2]
    site_rec = torch.clamp(
        (up[0] * rmaskf + up[1] * gmaskf + up[2] * bmaskf) * site_norm,
        min=0.0)
    opacity = torch.clamp(resize_bilinear(mask[3], (h, w)), 0.0, 1.0)
    return opacity * site_rec + (1.0 - opacity) * x
