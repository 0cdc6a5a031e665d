"""The raw side of the plain reference: black and white levels, white
balance, the highlight clamp and RCD demosaic, on an (H, W) float32
mosaic in sensor units.

RCD follows Luis Sanz Rodriguez's published algorithm as darktable/ansel
implement it (src/iop/demosaic/rcd.c): V/H discrimination, a
ratio-corrected low-pass, green at red and blue sites, P/Q diagonal
discrimination, the opposite chroma, then chroma at green sites.  The
mosaic is scaled to [0, 1] by the processed maximum, edge-padded by 12
pixels (RCD reads 10 away; 12 keeps the CFA phase), and the result
clamped at 0 and scaled back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-5
EPSSQ = 1e-10
PAD = 12


def cfa_plane(vals_by_site, h, w, device):
    """(h, w) plane of the value of each pixel's 2x2 site, row-major
    sites (0, 0), (0, 1), (1, 0), (1, 1)."""
    v = torch.tensor(vals_by_site, dtype=torch.float32, device=device)
    rp = torch.arange(h, device=device)[:, None] % 2
    cp = torch.arange(w, device=device)[None, :] % 2
    return v[rp * 2 + cp]


def site_colours(cfa):
    """'RGGB' -> [0, 1, 1, 2]: the colour index of each 2x2 site."""
    return ["RGB".index(ch) for ch in cfa]


def rawprepare(x, black, white):
    """(x - black) / (white - black) at every site."""
    return (x - black) * (1.0 / (white - black))


def white_balance(x, cfa, wb):
    """Multiply each site by its colour's coefficient; the second green
    site takes wb[3]."""
    vals, seen_green = [], False
    for c in site_colours(cfa):
        if c == 1:
            vals.append(wb[3] if seen_green else wb[1])
            seen_green = True
        else:
            vals.append(wb[c])
    return x * cfa_plane(vals, x.shape[0], x.shape[1], x.device)


def _sh(a, dy, dx):
    return torch.roll(a, shifts=(-dy, -dx), dims=(0, 1))


def _rcd(c, cfa):
    h, w = c.shape
    colour = cfa_plane(site_colours(cfa), h, w, c.device)
    is_r, is_g, is_b = colour == 0, colour == 1, colour == 2

    def hpf(dy, dx):
        return (_sh(c, -3 * dy, -3 * dx) - _sh(c, -dy, -dx)
                - _sh(c, dy, dx) + _sh(c, 3 * dy, 3 * dx)
                - 3.0 * (_sh(c, -2 * dy, -2 * dx) + _sh(c, 2 * dy, 2 * dx))
                + 6.0 * c) ** 2

    def stat(p, dy, dx):
        return torch.clamp(_sh(p, -dy, -dx) + p + _sh(p, dy, dx), min=EPSSQ)

    def refine(d):
        nbh = 0.25 * (_sh(d, -1, -1) + _sh(d, -1, 1)
                      + _sh(d, 1, -1) + _sh(d, 1, 1))
        return torch.where(torch.abs(0.5 - d) < torch.abs(0.5 - nbh), nbh, d)

    # 1: vertical / horizontal discrimination
    v_stat, h_stat = stat(hpf(1, 0), 1, 0), stat(hpf(0, 1), 0, 1)
    vh = refine(v_stat / (v_stat + h_stat))

    # 2: low-pass filter
    lpf = (c + 0.5 * (_sh(c, -1, 0) + _sh(c, 1, 0) + _sh(c, 0, -1)
                      + _sh(c, 0, 1))
           + 0.25 * (_sh(c, -1, -1) + _sh(c, -1, 1) + _sh(c, 1, -1)
                     + _sh(c, 1, 1)))

    # 3: green at red and blue sites
    def grad(dy, dx):
        near = torch.abs(_sh(c, -dy, -dx) - _sh(c, dy, dx))
        return (EPS + near + torch.abs(c - _sh(c, 2 * dy, 2 * dx))
                + torch.abs(_sh(c, dy, dx) - _sh(c, 3 * dy, 3 * dx))
                + torch.abs(_sh(c, 2 * dy, 2 * dx) - _sh(c, 4 * dy, 4 * dx)))

    def est(dy, dx):
        return _sh(c, dy, dx) * (lpf + lpf) / (
            EPS + lpf + _sh(lpf, 2 * dy, 2 * dx))

    n_g, s_g, w_g, e_g = grad(-1, 0), grad(1, 0), grad(0, -1), grad(0, 1)
    v_est = (s_g * est(-1, 0) + n_g * est(1, 0)) / (n_g + s_g)
    h_est = (w_g * est(0, 1) + e_g * est(0, -1)) / (e_g + w_g)
    g = torch.where(is_g, c, vh * h_est + (1.0 - vh) * v_est)

    # 4.0, 4.1: diagonal discrimination
    p_stat, q_stat = stat(hpf(1, 1), 1, 1), stat(hpf(1, -1), 1, -1)
    pq = refine(p_stat / (p_stat + q_stat))

    # 4.2: red at blue sites and blue at red sites
    def diag(dy, dx):
        return (EPS + torch.abs(_sh(c, -1, -dx * dy) - _sh(c, 1, dx * dy))
                + torch.abs(_sh(c, dy, dx) - _sh(c, 3 * dy, 3 * dx))
                + torch.abs(g - _sh(g, 2 * dy, 2 * dx)))

    def dg(dy, dx):
        return _sh(c, dy, dx) - _sh(g, dy, dx)

    nw, ne, sw, se = diag(-1, -1), diag(-1, 1), diag(1, -1), diag(1, 1)
    p_est = (nw * dg(1, 1) + se * dg(-1, -1)) / (nw + se)
    q_est = (ne * dg(1, -1) + sw * dg(-1, 1)) / (ne + sw)
    opp = g + (pq * q_est + (1.0 - pq) * p_est)
    zero = torch.zeros_like(c)
    r_nb = torch.where(is_r, c, torch.where(is_b, opp, zero))
    b_nb = torch.where(is_b, c, torch.where(is_r, opp, zero))

    # 4.3: red and blue at green sites
    def at_green(p):
        def side(dy, dx):
            return (EPS + torch.abs(g - _sh(g, 2 * dy, 2 * dx))
                    + torch.abs(_sh(p, -abs(dy), -abs(dx))
                                - _sh(p, abs(dy), abs(dx)))
                    + torch.abs(_sh(p, dy, dx) - _sh(p, 3 * dy, 3 * dx)))

        ng, sg, wg, eg = side(-1, 0), side(1, 0), side(0, -1), side(0, 1)
        v_e = (ng * (_sh(p, 1, 0) - _sh(g, 1, 0))
               + sg * (_sh(p, -1, 0) - _sh(g, -1, 0))) / (ng + sg)
        h_e = (eg * (_sh(p, 0, -1) - _sh(g, 0, -1))
               + wg * (_sh(p, 0, 1) - _sh(g, 0, 1))) / (eg + wg)
        return g + (vh * h_e + (1.0 - vh) * v_e)

    r = torch.where(is_g, at_green(r_nb), r_nb)
    b = torch.where(is_g, at_green(b_nb), b_nb)
    return torch.stack([r, g, b])


def rcd(x, cfa, scaler):
    """(H, W) mosaic -> (3, H, W) camera RGB."""
    h, w = x.shape
    c = torch.clamp(x, min=0.0) / max(scaler, 1e-9)
    cp = F.pad(c[None, None], (PAD,) * 4, mode="replicate")[0, 0]
    out = _rcd(cp, cfa)[:, PAD:PAD + h, PAD:PAD + w]
    return torch.clamp(out, min=0.0) * scaler


def raw_side(camera, hist):
    """rawprepare, temperature, highlights (the clamp) and demosaic (RCD)
    as (name, fn) stages for a camera entry of a configuration and the
    history's parameters by op."""
    cfa = camera["cfa"]
    black, white = float(camera["black"]), float(camera["white"])
    r, g, b, g2 = (float(v) for v in camera["wb"])
    wb = (r / g, 1.0, b / g, g2 / g if g2 else 1.0)
    hl = dict(hist.get("highlights", {}))
    dm = dict(hist.get("demosaic", {}))
    if hl.get("mode", 0) != 0 or dm.get("demosaicing_method", 5) != 5 \
            or dm.get("green_eq", 0) or dm.get("color_smoothing", 0):
        raise NotImplementedError("only the highlight clamp and plain RCD "
                                  "are written")
    # the processed maximum: 1 after the levels, the coefficients after
    # white balance, the clip level after the clamp
    clip = float(hl.get("clip", 1.0)) * min(wb[:3])
    scaler = min(max(wb[:3]), clip)
    return [
        ("rawprepare", lambda x: rawprepare(x, black, white)),
        ("temperature", lambda x: white_balance(x, cfa, wb)),
        ("highlights", lambda x: torch.clamp(x, max=clip)),
        ("demosaic", lambda x: rcd(x, cfa, scaler)),
    ]
