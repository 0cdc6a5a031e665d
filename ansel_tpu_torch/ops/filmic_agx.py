"""Filmic AgX color science (the v8 default rendering).

Reference: `ansel/src/iop/filmicrgb.c` — filmic_agx (filmicrgb.c:2436-2520),
inset/outset bracket construction (filmic_agx_prepare_bracket :2368-2434,
_filmic_agx_build_displaced :2322-2366), negative compression
(:2487-2516), Ych hue recovery, and the v6 gamut mapping
(gamut_mapping_simd :1965-2000, clip_chroma* :1797-1875, gamut_check_*
:1878-1962).

The host half (bracket matrices) is copied from
`ansel_tpu/ops/filmic_agx.py`; the per-pixel half is torch, written in the
reference's operand order.  Python-float arithmetic stays Python-float
(float64, rounded to float32 where it meets a tensor), exactly as in the
JAX version, and `gamut_fold` exposes those folds to the chain kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..color import matrices as cm
from ..color import spaces as sp
from ..color.transforms import apply_matrix

# fitted bracket anchors per colorscience variant (filmicrgb.c:2390-2430)
_BRACKETS = {
    5: (  # V6 no bleach
        (0.5991055, 0.6000000, 0.3300009),
        (0.0571015, 0.1999891, 0.0886110),
        (0.761433, 0.752267, 0.465293),
        (-0.0034297, 0.1952448, -0.0480109),
    ),
    6: (  # V7 low bleach
        (0.6410825, 0.6898110, 0.3194529),
        (0.0405734, 0.1631286, 0.0350584),
        (0.784757, 0.789387, 0.445403),
        (-0.0057845, 0.1593207, -0.0592955),
    ),
    7: (  # V8 medium bleach (default)
        (0.6509540, 0.7488775, 0.3517703),
        (0.0278602, 0.1214671, -0.0228829),
        (0.793082, 0.815169, 0.460318),
        (-0.0053781, 0.1187604, -0.0794801),
    ),
    8: (  # V9 high bleach
        (0.6379749, 0.7878689, 0.3753822),
        (0.0106096, 0.0582598, -0.0696729),
        (0.790237, 0.831376, 0.465406),
        (-0.0080070, 0.0571100, -0.0912220),
    ),
    9: (  # V10 extra bleach
        (0.5770235, 0.8102094, 0.4000390),
        (-0.0081060, -0.0034008, -0.1035236),
        (0.766420, 0.838020, 0.465130),
        (-0.0122011, -0.0021732, -0.0971215),
    ),
}

YRG_RW, YRG_GW = sp.YRG_WHITE_R, sp.YRG_WHITE_G
CIE_Y_2006 = 1.05785528  # CIE_Y_1931_to_CIE_Y_2006


def _xyz_to_yrg_np(xyz):
    lms = sp.XYZ_D65_TO_LMS2006 @ xyz
    Y = 0.68990272 * lms[0] + 0.34832189 * lms[1]
    a = lms.sum()
    norm = lms / a if a != 0 else lms * 0
    rgb = sp.LMS_TO_GRADING @ norm
    return np.array([Y, rgb[0], rgb[1]])


def _yrg_to_xyz_np(yrg):
    r, g = yrg[1], yrg[2]
    rgb = np.array([r, g, 1.0 - r - g])
    lms = sp.GRADING_TO_LMS @ rgb
    denom = 0.68990272 * lms[0] + 0.34832189 * lms[1]
    lms = lms * (yrg[0] / denom if denom != 0 else 0.0)
    return sp.LMS2006_TO_XYZ_D65 @ lms


def _build_displaced(inset, rotation) -> np.ndarray:
    """work RGB -> displaced rendering space (_filmic_agx_build_displaced)."""
    M_in = cm.XYZ_D50_TO_D65 @ cm.XYZ_FROM_WORK  # work -> XYZ D65
    M_out = cm.WORK_FROM_XYZ @ cm.XYZ_D65_TO_D50
    white_xyz = M_in @ np.ones(3)
    white_yrg = _xyz_to_yrg_np(white_xyz)
    P = np.zeros((3, 3))
    for i in range(3):
        p_yrg = _xyz_to_yrg_np(M_in[:, i])
        dr = p_yrg[1] - white_yrg[1]
        dg = p_yrg[2] - white_yrg[2]
        scale = 1.0 - min(max(inset[i], 0.0), 0.9)
        ca, sa = math.cos(rotation[i]), math.sin(rotation[i])
        displaced = np.array([p_yrg[0],
                              white_yrg[1] + scale * (ca * dr - sa * dg),
                              white_yrg[2] + scale * (sa * dr + ca * dg)])
        P[:, i] = _yrg_to_xyz_np(displaced)
    s = np.linalg.solve(P, white_xyz)
    P = P * s[None, :]
    return M_out @ P


def prepare_bracket(version: int):
    """-> (inset, outset) 3x3 matrices in work RGB."""
    anchors = _BRACKETS.get(version, _BRACKETS[7])
    ia, ir, oa, orot = anchors
    inset = _build_displaced(ia, ir)
    recovery = _build_displaced(oa, orot)
    outset = np.linalg.inv(recovery)
    return inset.astype(np.float32), outset.astype(np.float32)


def agx_matrices():
    """input (work->LMS2006) / output (LMS2006->work) matrices."""
    input_m = sp.XYZ_D65_TO_LMS2006 @ cm.XYZ_D50_TO_D65 @ cm.XYZ_FROM_WORK
    output_m = cm.WORK_FROM_XYZ @ cm.XYZ_D65_TO_D50 @ sp.LMS2006_TO_XYZ_D65
    return input_m.astype(np.float32), output_m.astype(np.float32)


# --- device-side pieces ------------------------------------------------------

INF = float("inf")


def compress_negatives(rgb, luma):
    """filmic_agx_compress_negatives (filmicrgb.c:2487-2516).
    `luma` is a sequence of 3 Python floats."""
    l0, l1, l2 = (float(v) for v in luma)

    def dotY(v):
        return l0 * v[0] + l1 * v[1] + l2 * v[2]

    input_y = dotY(rgb)
    max_rgb = torch.amax(rgb, dim=0)
    min_rgb = torch.amin(rgb, dim=0)
    opp = max_rgb[None] - rgb
    opp_y = dotY(opp)
    max_opp = torch.amax(opp, dim=0)
    y_comp = max_opp - opp_y + input_y
    offset = torch.clamp(-min_rgb, min=0.0)
    shifted = rgb + offset[None]
    max_sh = torch.amax(shifted, dim=0)
    opp_sh = max_sh[None] - shifted
    max_opp_sh = torch.amax(opp_sh, dim=0)
    y_opp_sh = dotY(opp_sh)
    y_new = dotY(shifted) + max_opp_sh - y_opp_sh
    ratio = torch.where((y_new > y_comp) & (y_new > 1e-6), y_comp / y_new, 1.0)
    return shifted * ratio[None]


def rgb_to_ych(rgb, input_m):
    """-> (Y, c, cos_h, sin_h) (pipe_RGB_to_Ych_simd, filmicrgb.c:1719)."""
    yrg = sp.lms_to_yrg(apply_matrix(rgb, input_m))
    r = yrg[1] - YRG_RW
    g = yrg[2] - YRG_GW
    c = torch.sqrt(r * r + g * g)
    cos_h = torch.where(c != 0.0, r / torch.clamp(c, min=1e-20), 1.0)
    sin_h = torch.where(c != 0.0, g / torch.clamp(c, min=1e-20), 0.0)
    return yrg[0], c, cos_h, sin_h


def ych_to_rgb(Y, c, cos_h, sin_h, output_m):
    yrg = torch.stack([Y, c * cos_h + YRG_RW, c * sin_h + YRG_GW])
    return apply_matrix(sp.yrg_to_lms(yrg), output_m)


def gamut_fold(coeffs):
    """The two float64 folds of one output-matrix row that the reference
    computes in Python: (S, -0.427506877216495 * S)."""
    s = coeffs[0] + 0.856492345150334 * coeffs[1] \
        + 0.554995960637719 * coeffs[2]
    return s, -0.427506877216495 * s


def _clip_chroma_white(coeffs, target_white, Y, cos_h, sin_h):
    """clip_chroma_white (filmicrgb.c:1797-1838); coeffs = one row of the
    LMS->work output matrix as Python floats."""
    den_y = (coeffs[0] * (0.979381443298969 * cos_h + 0.391752577319588 * sin_h)
             + coeffs[1] * (0.0206185567010309 * cos_h + 0.608247422680412 * sin_h)
             - coeffs[2] * (cos_h + sin_h))
    den_t = target_white * (0.68285981628866 * cos_h
                            + 0.482137060515464 * sin_h)
    s, _ = gamut_fold(coeffs)

    def raw(Yv):
        denominator = Yv * den_y - den_t
        numerator = -0.427506877216495 * (
            Yv * s - 0.988237752433297 * target_white)
        Y_asym = den_t / torch.where(den_y == 0.0, 1e30, den_y)
        val = numerator / torch.where(torch.abs(denominator) < 1e-20,
                                      1e-20, denominator)
        return torch.where((den_y == 0.0) | (Yv <= Y_asym), INF, val)

    eps = 1e-3
    max_Y = CIE_Y_2006 * target_white
    delta_Y = torch.clamp(max_Y - Y, min=0.0)
    near = delta_Y < eps
    v_near = delta_Y / (eps * max_Y) * raw(
        torch.full_like(Y, 1.0) * ((1 - eps) * max_Y))
    v_far = raw(Y)
    v = torch.where(near, v_near, v_far)
    return torch.where(v >= 0.0, v, INF)


def _clip_chroma_black(coeffs, cos_h, sin_h):
    den = (coeffs[0] * (0.979381443298969 * cos_h + 0.391752577319588 * sin_h)
           + coeffs[1] * (0.0206185567010309 * cos_h
                          + 0.608247422680412 * sin_h)
           - coeffs[2] * (cos_h + sin_h))
    _, num = gamut_fold(coeffs)
    v = num / torch.where(torch.abs(den) < 1e-20, 1e-20, den)
    return torch.where((den == 0.0) | (v < 0.0), INF, v)


def gamut_map(Y, c, cos_h, sin_h, input_m, output_m, display_black,
              display_white):
    """gamut_check_Yrg + gamut_check_RGB (filmicrgb.c:1878-1962)."""
    # keep the Yrg chromaticity triangle valid
    r = c * cos_h + YRG_RW
    g = c * sin_h + YRG_GW
    safe_cos = torch.where(torch.abs(cos_h) > 1e-9, cos_h, 1e-9)
    safe_sin = torch.where(torch.abs(sin_h) > 1e-9, sin_h, 1e-9)
    c = torch.where(r < 0.0, torch.minimum(-YRG_RW / safe_cos, c), c)
    c = torch.where(g < 0.0, torch.minimum(-YRG_GW / safe_sin, c), c)
    c = torch.where(r + g > 1.0,
                    torch.minimum((1.0 - YRG_RW - YRG_GW)
                                  / (safe_cos + safe_sin), c), c)

    rgb_b = ych_to_rgb(Y, c, cos_h, sin_h, output_m)
    offset = torch.clamp(-torch.amin(rgb_b, dim=0), min=0.0)
    rgb_b = rgb_b + offset[None]
    Yb, _, _, _ = rgb_to_ych(rgb_b, input_m)
    Y2 = torch.clamp((Y + Yb) / 2.0, CIE_Y_2006 * display_black,
                     CIE_Y_2006 * display_white)
    max_c = c
    for row in range(3):
        coeffs = [float(output_m[row][k]) for k in range(3)]
        max_c = torch.minimum(max_c, _clip_chroma_white(
            coeffs, display_white, Y2, cos_h, sin_h))
        max_c = torch.minimum(max_c, _clip_chroma_black(coeffs, cos_h, sin_h))
    out = ych_to_rgb(Y2, max_c, cos_h, sin_h, output_m)
    return torch.clamp(out, torch.zeros_like(display_white), display_white)


def desaturate_v4(Y0, c0, Yf, cf, saturation):
    """filmic_desaturate_v4 (filmicrgb.c:1757-1793): a linear model of
    chroma against luminance, with the brightening and resaturation
    guards.  `saturation` is a 0-d tensor, or the Python float 0.0 that
    colour science v5 passes."""
    chroma_o = c0 * Y0
    chroma_f = cf * Yf
    delta = saturation * (chroma_o - chroma_f)
    brightens = Yf > Y0
    resat = chroma_o < chroma_f
    desat = chroma_o > chroma_f
    user_resat = saturation > 0.0
    user_desat = saturation < 0.0
    chroma_final = torch.where(
        brightens & resat, 0.5 * (chroma_o + chroma_f),
        torch.where((user_resat & desat) | user_desat,
                    chroma_f + delta, chroma_f))
    return torch.clamp(chroma_final / torch.clamp(Yf, min=1e-9), min=0.0)
