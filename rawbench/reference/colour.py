"""Per-pixel colour stages of the plain reference on (3, H, W) float32
tensors: exposure, the input profile, colour calibration (CAT16 to the
D50 pipeline white with its gamut compression), filmic rgb's AgX
rendering (colour science v8), the sRGB output profile and the
work RGB <-> CIE Lab conversions.

Each stage takes the history item's parameters over the defaults that
darktable/ansel gives the module, and works its coefficients out from
them here (src/iop/exposure.c, colorin.c, channelmixerrgb.c,
filmicrgb.c, colorout.c).
"""

from __future__ import annotations

import numpy as np
import torch

from . import colormath as cmath

NORM_MIN = 1.52587890625e-05


def matmul3(x, M):
    """(3, H, W) by a 3x3 matrix, each row summed left to right."""
    M = np.asarray(M, np.float64).astype(np.float32).tolist()
    return torch.stack([(M[r][0] * x[0] + M[r][1] * x[1]) + M[r][2] * x[2]
                        for r in range(3)])


def exposure(x, p):
    black = float(p.get("black", 0.0))
    scale = 1.0 / (2.0 ** -float(p.get("exposure", 0.0)) - black)
    return (x - black) * scale


def colorin(x, cam_to_xyz):
    return matmul3(x, cmath.cam_to_work(cam_to_xyz))


CHANNELMIXER_DEFAULTS = {"illuminant": 2, "temperature": 5003.0,
                         "adaptation": 1, "gamut": 1.0, "clip": 1}


def channelmixerrgb(x, p):
    """Colour calibration at its defaults: a CAT16 von Kries adaptation
    from daylight at `temperature` to the D50 pipeline white, the
    identity mix, gamut compression toward white in CIE 1976 uv, clipped
    at 0."""
    q = dict(CHANNELMIXER_DEFAULTS, **p)
    if (q["illuminant"], q["adaptation"], q["gamut"], q["clip"]) != (
            2, 1, 1.0, 1) or set(p) - set(CHANNELMIXER_DEFAULTS):
        raise NotImplementedError("channelmixerrgb: only the default "
                                  "CAT16 daylight calibration is written")
    ix, iy = cmath.daylight_xy(q["temperature"])
    illum = cmath.xy_to_XYZ(ix, iy)
    cone = cmath.CAT16
    il = np.float32(cone @ (illum / illum[1])).tolist()
    wl = np.float32(cone @ cmath.PIPE_WHITE_XYZ).tolist()

    x = torch.clamp(x, min=0.0)
    xyz = matmul3(x, cmath.XYZ_FROM_WORK)
    Y = torch.where(xyz[1] > NORM_MIN, xyz[1] + NORM_MIN, NORM_MIN)[None]
    lms = matmul3(xyz, cone) / Y
    adapted = torch.stack([lms[i] / il[i] * wl[i] for i in range(3)])
    xyz = matmul3(adapted * Y, np.linalg.inv(cone))
    xyz = _gamut(xyz)
    return torch.clamp(matmul3(xyz, cmath.WORK_FROM_XYZ), min=0.0)


def _gamut(xyz):
    """Pull each colour's uv toward the white's by Y times its squared
    uv distance, then back to XYZ at the same Y (gamut 1, clip on)."""
    xw, yw = cmath.WP_D50
    den = -2.0 * xw + 12.0 * yw + 3.0
    uw, vw = (float(np.float32(v)) for v in (4.0 * xw / den, 9.0 * yw / den))
    s = xyz[0] + xyz[1] + xyz[2]
    Y = xyz[1]
    valid = (s > 0) & (Y > 0)
    safe = torch.where(valid, s, 1.0)
    xx = xyz[0] / safe
    yy = torch.where(valid, xyz[1] / safe, 1.0)
    d = -2.0 * xx + 12.0 * yy + 3.0
    u, v = 4.0 * xx / d, 9.0 * yy / d
    du, dv = uw - u, vw - v
    corr = Y * (du * du + dv * dv)
    tu, tv = corr * du + u, corr * dv + v
    u = torch.where(u > uw, torch.clamp(tu, min=uw), torch.clamp(tu, max=uw))
    v = torch.where(v > vw, torch.clamp(tv, min=vw), torch.clamp(tv, max=vw))
    d = 6.0 * u - 16.0 * v + 12.0
    xx = torch.clamp(9.0 * u / d, min=0.0)
    yy = torch.clamp(torch.clamp(4.0 * v / d, min=0.0), min=NORM_MIN)
    scale = xx + yy
    big = scale >= 1.0
    xx = torch.where(big, xx / scale, xx)
    yy = torch.where(big, yy / scale, yy)
    out = torch.stack([Y * xx / yy, Y, Y * (1.0 - xx - yy) / yy])
    return torch.where(valid[None], out, torch.zeros_like(out))


# --- filmic rgb, colour science v8 (AgX) -----------------------------------

FILMIC_DEFAULTS = {
    "grey_point_source": 18.45, "black_point_source": -8.0,
    "white_point_source": 4.0, "grey_point_target": 18.45,
    "black_point_target": 0.01517634,
    "white_point_target": 100.0, "output_power": 4.0, "latitude": 10.0,
    "contrast": 1.18, "saturation": 0.0, "balance": 0.0, "version": 7,
    "custom_grey": 0, "shadows": 3, "highlights": 3, "spline_version": 2,
}


def _sigmoid_scale(limit_x, limit_y, tx, ty, slope, power):
    projected = slope * max(1e-6, limit_x - tx)
    actual = max(1e-6, limit_y - ty)
    base = max(1e-6, actual ** (-power) - projected ** (-power))
    return min(1e9, base ** (-1.0 / power))


def filmic_spline(p):
    """The v3 spline with sigmoid toe and shoulder (filmicrgb.c
    filmic_v3_compute_geometry, dt_iop_filmic_rgb_compute_spline) ->
    its float32 coefficients."""
    q = dict(FILMIC_DEFAULTS, **p)
    if (q["version"], q["shadows"], q["highlights"], q["spline_version"],
            q["custom_grey"]) != (7, 3, 3, 2, 0):
        raise NotImplementedError("filmicrgb: only AgX v8 with the v3 "
                                  "sigmoid spline is written")
    power = q["output_power"]
    dr = q["white_point_source"] - q["black_point_source"]
    grey_log = abs(q["black_point_source"]) / dr
    grey_disp = 0.1845 ** (1.0 / power)
    grey_target = q["grey_point_target"]
    black_disp = (min(max(q["black_point_target"], 0.0), grey_target)
                  / 100.0) ** (1.0 / power)
    white_disp = (max(q["white_point_target"], grey_target) / 100.0) \
        ** (1.0 / power)
    slope = q["contrast"] * dr / 8.0
    min_c = max(1.0, (white_disp - grey_disp) / (1.0 - grey_log),
                (grey_disp - black_disp) / grey_log) + 0.01
    contrast = slope / (power * grey_disp ** (power - 1.0))
    contrast = min(max(contrast, min_c), 100.0)
    intercept = grey_disp - contrast * grey_log
    margin = 0.01 * (white_disp - black_disp)
    xmin = (black_disp + margin - intercept) / contrast
    xmax = (white_disp - margin - intercept) / contrast
    lat = min(max(q["latitude"], 0.0), 100.0) / 100.0
    balance = min(max(q["balance"], -50.0), 50.0) / 100.0
    toe = (1.0 - lat) * grey_log + lat * xmin
    shoulder = (1.0 - lat) * grey_log + lat * xmax
    corr = 2.0 * balance * (shoulder - grey_log) if balance > 0.0 \
        else 2.0 * balance * (grey_log - toe)
    toe, shoulder = max(toe - corr, xmin), min(shoulder - corr, xmax)
    x = [0.0, toe, grey_log, shoulder, 1.0]
    y = [black_disp, toe * contrast + intercept, grey_disp,
         shoulder * contrast + intercept, white_disp]

    lin_a = contrast                  # linear part: y = lin_b + lin_a x
    lin_b = y[1] - contrast * x[1]
    # toe
    dx, dy = max(1e-6, x[1]), max(1e-6, y[1] - y[0])
    toe_scale = -_sigmoid_scale(1.0, 1.0 - y[0], 1.0 - x[1], 1.0 - y[1],
                                contrast, 1.5)
    toe_exp = contrast * dx / dy
    toe_mul = dy / dx ** toe_exp
    toe_pow = 1.0 if dy / dx > contrast else 0.0
    # shoulder
    dx, dy = max(1e-6, 1.0 - x[3]), max(1e-6, y[4] - y[3])
    sh_exp = contrast * dx / dy
    sh_mul = dy / dx ** sh_exp
    sh_scale = _sigmoid_scale(1.0, y[4], x[3], y[3], contrast, sh_exp)
    f = float
    return {
        "M1": np.float32([toe_scale, sh_scale, lin_b]),
        "M2": np.float32([1.5, sh_exp, lin_a]),
        "M3": np.float32([toe_mul, sh_mul, y[0]]),
        "M4": np.float32([toe_exp, sh_exp, y[4]]),
        "M5": np.float32([toe_pow, 1.0, 0.0]),
        "lat_min": np.float32(x[1]), "lat_max": np.float32(x[3]),
        "grey": np.float32(0.1845),
        "black": np.float32(q["black_point_source"]),
        "dr": np.float32(dr), "power": np.float32(power),
        "y4": np.float32(y[4]),
        "display_black": np.float32(f(y[0]) ** power),
        "display_white": np.float32(f(y[4]) ** power),
        "beta_hue": np.float32(0.5 * (min(max(q["saturation"] / 100.0,
                                              -1.0), 1.0) + 1.0)),
    }


def _spline_eval(x, c):
    """Sigmoid toe below the latitude, sigmoid shoulder above it, the
    straight line between."""
    M1, M2, M3, M4, M5 = (c[k].tolist() for k in ("M1", "M2", "M3", "M4",
                                                   "M5"))
    lo, hi = float(c["lat_min"]), float(c["lat_max"])
    ty = lo * M2[2] + M1[2]
    u = M2[2] * (x - lo) / M1[0]
    sig = M1[0] * (u / (1.0 + u ** M2[0]) ** (1.0 / M2[0])) + ty
    powc = M3[2] + torch.clamp(M3[0] * torch.clamp(x, min=0.0) ** M4[0],
                               min=0.0)
    toe = powc if M5[0] != 0.0 else sig
    ty = hi * M2[2] + M1[2]
    u = M2[2] * (x - hi) / M1[1]
    sig = M1[1] * (u / (1.0 + u ** M2[1]) ** (1.0 / M2[1])) + ty
    powc = M4[2] - torch.clamp(M3[1] * torch.clamp(1.0 - x, min=0.0)
                               ** M4[1], min=0.0)
    shoulder = powc if M5[1] != 0.0 else sig
    return torch.where(x < lo, toe,
                       torch.where(x > hi, shoulder, M1[2] + x * M2[2]))


def _lms_to_yrg(lms):
    Y = 0.68990272 * lms[0] + 0.34832189 * lms[1]
    a = lms[0] + lms[1] + lms[2]
    inv = torch.where(a == 0.0, 0.0, 1.0 / a)
    rgb = matmul3(lms * inv[None], cmath.LMS_TO_GRADING)
    return torch.stack([Y, rgb[0], rgb[1]])


def _yrg_to_lms(yrg):
    rgb = torch.stack([yrg[1], yrg[2], 1.0 - yrg[1] - yrg[2]])
    lms = matmul3(rgb, cmath.GRADING_TO_LMS)
    den = 0.68990272 * lms[0] + 0.34832189 * lms[1]
    return lms * torch.where(den == 0.0, 0.0, yrg[0] / den)[None]


def _to_ych(rgb, to_lms):
    yrg = _lms_to_yrg(matmul3(rgb, to_lms))
    r, g = yrg[1] - cmath.YRG_WHITE[0], yrg[2] - cmath.YRG_WHITE[1]
    c = torch.sqrt(r * r + g * g)
    cos_h = torch.where(c != 0.0, r / torch.clamp(c, min=1e-20), 1.0)
    sin_h = torch.where(c != 0.0, g / torch.clamp(c, min=1e-20), 0.0)
    return yrg[0], c, cos_h, sin_h


def _from_ych(Y, c, cos_h, sin_h, from_lms):
    yrg = torch.stack([Y, c * cos_h + cmath.YRG_WHITE[0],
                       c * sin_h + cmath.YRG_WHITE[1]])
    return matmul3(_yrg_to_lms(yrg), from_lms)


def _compress_negatives(rgb):
    l0, l1, l2 = (float(v) for v in cmath.WORK_Y)

    def lum(v):
        return l0 * v[0] + l1 * v[1] + l2 * v[2]

    opp = torch.amax(rgb, dim=0)[None] - rgb
    y_comp = torch.amax(opp, dim=0) - lum(opp) + lum(rgb)
    shifted = rgb + torch.clamp(-torch.amin(rgb, dim=0), min=0.0)[None]
    opp = torch.amax(shifted, dim=0)[None] - shifted
    y_new = lum(shifted) + torch.amax(opp, dim=0) - lum(opp)
    ratio = torch.where((y_new > y_comp) & (y_new > 1e-6), y_comp / y_new,
                        1.0)
    return shifted * ratio[None]


def _fold(row):
    s = row[0] + 0.856492345150334 * row[1] + 0.554995960637719 * row[2]
    return s, -0.427506877216495 * s


def _den(row, cos_h, sin_h):
    return (row[0] * (0.979381443298969 * cos_h + 0.391752577319588 * sin_h)
            + row[1] * (0.0206185567010309 * cos_h
                        + 0.608247422680412 * sin_h)
            - row[2] * (cos_h + sin_h))


def _max_chroma_white(row, white, Y, cos_h, sin_h):
    """The chroma at which this output channel reaches `white`."""
    inf = float("inf")
    den_y = _den(row, cos_h, sin_h)
    den_t = white * (0.68285981628866 * cos_h + 0.482137060515464 * sin_h)
    s, _ = _fold(row)

    def at(Yv):
        den = Yv * den_y - den_t
        num = -0.427506877216495 * (Yv * s - 0.988237752433297 * white)
        y_asym = den_t / torch.where(den_y == 0.0, 1e30, den_y)
        val = num / torch.where(torch.abs(den) < 1e-20, 1e-20, den)
        return torch.where((den_y == 0.0) | (Yv <= y_asym), inf, val)

    eps = 1e-3
    max_y = cmath.CIE_Y_2006 * white
    delta = torch.clamp(max_y - Y, min=0.0)
    v = torch.where(delta < eps,
                    delta / (eps * max_y)
                    * at(torch.full_like(Y, 1.0) * ((1 - eps) * max_y)),
                    at(Y))
    return torch.where(v >= 0.0, v, inf)


def _max_chroma_black(row, cos_h, sin_h):
    den = _den(row, cos_h, sin_h)
    _, num = _fold(row)
    v = num / torch.where(torch.abs(den) < 1e-20, 1e-20, den)
    return torch.where((den == 0.0) | (v < 0.0), float("inf"), v)


def _gamut_map(Y, c, cos_h, sin_h, to_lms, from_lms, black, white):
    rw, gw = cmath.YRG_WHITE
    r, g = c * cos_h + rw, c * sin_h + gw
    sc = torch.where(torch.abs(cos_h) > 1e-9, cos_h, 1e-9)
    ss = torch.where(torch.abs(sin_h) > 1e-9, sin_h, 1e-9)
    c = torch.where(r < 0.0, torch.minimum(-rw / sc, c), c)
    c = torch.where(g < 0.0, torch.minimum(-gw / ss, c), c)
    c = torch.where(r + g > 1.0, torch.minimum((1.0 - rw - gw) / (sc + ss),
                                               c), c)
    rgb = _from_ych(Y, c, cos_h, sin_h, from_lms)
    rgb = rgb + torch.clamp(-torch.amin(rgb, dim=0), min=0.0)[None]
    Yb = _to_ych(rgb, to_lms)[0]
    Y2 = torch.clamp((Y + Yb) / 2.0, cmath.CIE_Y_2006 * black,
                     cmath.CIE_Y_2006 * white)
    rows = np.float32(from_lms).tolist()
    for row in rows:
        c = torch.minimum(c, _max_chroma_white(row, white, Y2, cos_h, sin_h))
        c = torch.minimum(c, _max_chroma_black(row, cos_h, sin_h))
    return torch.clamp(_from_ych(Y2, c, cos_h, sin_h, from_lms), 0.0, white)


def filmic_agx(x, p):
    """AgX: negatives compressed, the inset primaries, the log tone curve
    through the sigmoid spline, the outset primaries, the hue and chroma
    recovered in Yrg, then mapped into the display gamut."""
    c = filmic_spline(p)
    inset, outset, to_lms, from_lms = cmath.agx_matrices()
    to_lms, from_lms = np.float32(to_lms), np.float32(from_lms)
    black, white = float(c["display_black"]), float(c["display_white"])

    x = torch.clamp(torch.nan_to_num(x), -1e6, 1e6)
    x = _compress_negatives(x)
    Y0, c0, cos0, sin0 = _to_ych(x, to_lms)
    rendering = matmul3(x, inset)
    logv = torch.clamp((torch.log2(torch.clamp(rendering, min=NORM_MIN)
                                   / float(c["grey"])) - float(c["black"]))
                       / float(c["dr"]), 0.0, 1.0)
    rendering = torch.clamp(_spline_eval(logv, c), 0.0, float(c["y4"])) \
        ** float(c["power"])
    out = matmul3(rendering, outset)
    Yf, cf, cosf, sinf = _to_ych(out, to_lms)
    chroma = torch.minimum(c0, cf)
    beta = float(c["beta_hue"])
    r_mix = beta * c0 * cos0 + (1.0 - beta) * chroma * cosf
    g_mix = beta * c0 * sin0 + (1.0 - beta) * chroma * sinf
    norm = torch.sqrt(r_mix ** 2 + g_mix ** 2)
    cos_h = torch.where(norm > 1e-9, r_mix / torch.clamp(norm, min=1e-20),
                        cos0)
    sin_h = torch.where(norm > 1e-9, g_mix / torch.clamp(norm, min=1e-20),
                        sin0)
    Yf = torch.clamp(Yf, cmath.CIE_Y_2006 * black, cmath.CIE_Y_2006 * white)
    return _gamut_map(Yf, chroma, cos_h, sin_h, to_lms, from_lms, black,
                      white)


def colorout_srgb(x):
    """Work RGB -> sRGB primaries, clipped to [0, 1], the sRGB curve."""
    y = torch.clamp(matmul3(x, cmath.work_to_display("srgb")), 0.0, 1.0)
    return torch.where(y <= 0.0031308, 12.92 * y,
                       1.055 * torch.clamp(y, min=1e-9) ** (1.0 / 2.4)
                       - 0.055)


LAB_EPS = 216.0 / 24389.0
LAB_KAPPA = 24389.0 / 27.0


def work_to_lab(x):
    xyz = matmul3(x, cmath.XYZ_FROM_WORK)
    w = cmath.PIPE_WHITE_XYZ.tolist()
    f = []
    for i in range(3):
        r = xyz[i] / w[i]
        f.append(torch.where(r > LAB_EPS,
                             torch.clamp(r, min=1e-12) ** (1.0 / 3.0),
                             (LAB_KAPPA * r + 16.0) / 116.0))
    return torch.stack([116.0 * f[1] - 16.0, 500.0 * (f[0] - f[1]),
                        200.0 * (f[1] - f[2])])


def lab_to_work(lab):
    w = cmath.PIPE_WHITE_XYZ.tolist()
    fy = (lab[0] + 16.0) / 116.0
    out = []
    for i, fc in enumerate((fy + lab[1] / 500.0, fy, fy - lab[2] / 200.0)):
        f3 = fc * fc * fc
        out.append(torch.where(f3 > LAB_EPS, f3,
                               (116.0 * fc - 16.0) / LAB_KAPPA) * w[i])
    return matmul3(torch.stack(out), cmath.WORK_FROM_XYZ)
