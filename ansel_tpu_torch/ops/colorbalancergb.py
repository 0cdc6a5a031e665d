"""colorbalancergb — 4-way scene-referred color grading.

Reference: `ansel/src/iop/colorbalancergb.c` (params v5,
colorbalancergb.c:87-133), as `ansel_tpu/ops/colorbalancergb.py` has it:
work RGB -> CIE2006 LMS -> Kirk Yrg; hue rotation and chroma/vibrance
with gamut guards in the (r, g) plane; the 4-way grade in Filmlight
grading RGB (opacity masks colorbalancergb.c:509-534); contrast around
the grey fulcrum; then saturation and brilliance in JzAzBz (the v4
formula, `plan.static` 0) or dt UCS 22 (the v5 default, 1).  The host
half (commit_params, the per-hue gamut LUT and its Fourier fit) is
copied; the per-pixel half is torch here and the COLORBALANCERGB stage
of the chain kernel, with the formula as its static int.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..color import matrices as cm
from ..color import spaces as sp
from ..color.transforms import apply_matrix, fdiv
from ..core.params import cfield, params
from ..core.types import Colorspace
from ..kernels.pointwise import OP_COLORBALANCERGB, atan_pos
from .base import Op, OpPlan, PlanContext, PointwiseSpec, register

SAT_JZAZBZ = 0
SAT_DTUCS = 1


@params(op="colorbalancergb", version=5)
@dataclasses.dataclass
class ColorBalanceRGBParams:
    shadows_Y: float = cfield("f", 0.0)
    shadows_C: float = cfield("f", 0.0)
    shadows_H: float = cfield("f", 0.0)
    midtones_Y: float = cfield("f", 0.0)
    midtones_C: float = cfield("f", 0.0)
    midtones_H: float = cfield("f", 0.0)
    highlights_Y: float = cfield("f", 0.0)
    highlights_C: float = cfield("f", 0.0)
    highlights_H: float = cfield("f", 0.0)
    global_Y: float = cfield("f", 0.0)
    global_C: float = cfield("f", 0.0)
    global_H: float = cfield("f", 0.0)
    shadows_weight: float = cfield("f", 1.0)
    white_fulcrum: float = cfield("f", 1.0)
    highlights_weight: float = cfield("f", 1.0)
    chroma_shadows: float = cfield("f", 0.0)
    chroma_highlights: float = cfield("f", 0.0)
    chroma_global: float = cfield("f", 0.0)
    chroma_midtones: float = cfield("f", 0.0)
    saturation_global: float = cfield("f", 0.0)
    saturation_highlights: float = cfield("f", 0.0)
    saturation_midtones: float = cfield("f", 0.0)
    saturation_shadows: float = cfield("f", 0.0)
    hue_angle: float = cfield("f", 0.0)
    brilliance_global: float = cfield("f", 0.0)
    brilliance_highlights: float = cfield("f", 0.0)
    brilliance_midtones: float = cfield("f", 0.0)
    brilliance_shadows: float = cfield("f", 0.0)
    mask_grey_fulcrum: float = cfield("f", 0.1845)
    vibrance: float = cfield("f", 0.0)
    grey_fulcrum: float = cfield("f", 0.1845)
    contrast: float = cfield("f", 0.0)
    saturation_formula: int = cfield("i", 1)

    @classmethod
    def from_legacy(cls, version, raw):
        if version == 4:
            # colorbalancergb.c:248-292 — v4 = v5 minus saturation_formula;
            # legacy edits keep the JzAzBz (2021) saturation algorithm
            p = cls.codec.decode(raw + b"\0" * 4)
            p.saturation_formula = 0  # DT_COLORBALANCE_SATURATION_JZAZBZ
            return p
        return None


MASK_EXP = 0.4101205819200422

_LUT_ELEM = 360
_FOURIER_K = 48


def _xyz_to_jzazbz_np(xyz):
    """(N, 3) XYZ D65 -> JzAzBz, host-side (mirror of spaces.py)."""
    X, Y, Z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    Xp = sp._JZ_B * X - (sp._JZ_B - 1.0) * Z
    Yp = sp._JZ_G * Y - (sp._JZ_G - 1.0) * X
    lms = np.stack([Xp, Yp, Z], -1) @ sp._JZ_M.T
    y = np.maximum(lms / 10000.0, 0.0) ** sp._JZ_N
    pq = ((sp._JZ_C1 + sp._JZ_C2 * y) / (1.0 + sp._JZ_C3 * y)) ** sp._JZ_P
    iab = pq @ sp._JZ_A.T
    Jz = np.maximum((1.0 + sp._JZ_D) * iab[:, 0]
                    / (1.0 + sp._JZ_D * iab[:, 0]) - sp._JZ_D0, 0.0)
    return Jz, iab[:, 1], iab[:, 2]


def _xyY_to_ucs_uv_np(xy):
    """(N, 2) CIE xy -> dt UCS UV* prime (xyY_to_dt_UCS_UV,
    colorspaces_inline_conversions.h:1276-1299)."""
    xf = np.array([-0.783941002840055, 0.745273540913283,
                   0.318707282433486])
    yf = np.array([0.277512987809202, -0.205375866083878,
                   2.16743692732158])
    of = np.array([0.153836578598858, -0.165478376301988,
                   0.291320554395942])
    UVD = xy[:, :1] * xf + xy[:, 1:2] * yf + of
    U, V = UVD[:, 0] / UVD[:, 2], UVD[:, 1] / UVD[:, 2]
    fac = (1.39656225667, 1.4513954287)
    half = (1.49217352929, 1.52488637914)
    Us = fac[0] * U / (np.abs(U) + half[0])
    Vs = fac[1] * V / (np.abs(V) + half[1])
    Up = -1.124983854323892 * Us - 0.980483721769325 * Vs
    Vp = 1.86323315098672 * Us + 1.971853092390862 * Vs
    return Up, Vp


def _gamut_lut(formula: int, work_to_xyzd65: np.ndarray) -> np.ndarray:
    """The per-hue gamut LUT (colorbalancergb.c:1214-1348): the JzAzBz
    formula stores the max saturation Cz/Jz, dt UCS the M^2 colorfulness
    of the work primaries' triangle boundary."""
    if formula == SAT_JZAZBZ:
        steps = 92
        g1 = np.linspace(0.0, 1.0, steps)
        r, g, b = np.meshgrid(g1, g1, g1, indexing="ij")
        rgb = np.stack([r, g, b], -1).reshape(-1, 3)
        XYZ = rgb @ work_to_xyzd65.T
        Jz, az, bz = _xyz_to_jzazbz_np(XYZ)
        Cz = np.hypot(bz, az)
        hue = np.arctan2(bz, az)
        sat = np.where(Jz > 0.0, Cz / np.maximum(Jz, 1e-12), 0.0)
        idx = np.round((_LUT_ELEM - 1) * (hue + np.pi)
                       / (2.0 * np.pi)).astype(int)
        raw = np.zeros(_LUT_ELEM)
        np.maximum.at(raw, idx, sat)
        # 5-tap circular box smooth (:1259-1266)
        pad = np.concatenate([raw[-2:], raw, raw[:2]])
        return np.convolve(pad, np.ones(5) / 5.0, "valid")
    # dt UCS: march the work-primaries triangle boundary in xy
    prim_xyz = np.eye(3) @ work_to_xyzd65.T
    prim_xy = prim_xyz[:, :2] / prim_xyz.sum(-1, keepdims=True)
    n = 50 * 360 * 4
    t = np.linspace(0.0, 1.0, n // 3, endpoint=False)
    pts = []
    for a in range(3):
        pa, pb = prim_xy[a], prim_xy[(a + 1) % 3]
        pts.append(pa + t[:, None] * (pb - pa))
    pts = np.concatenate(pts)
    Up, Vp = _xyY_to_ucs_uv_np(pts)
    H = np.degrees(np.arctan2(Vp, Up))
    M2 = Up * Up + Vp * Vp
    idx = (np.round(H).astype(int) + 180) % 360
    lut = np.zeros(_LUT_ELEM)
    np.maximum.at(lut, idx, M2)
    return lut


def _fourier_fit(lut: np.ndarray, K: int = _FOURIER_K) -> np.ndarray:
    """LUT over hue -> 2K+1 Fourier coefficients: the reference's per-pixel
    LUT gather becomes a truncated series evaluated from (cos h, sin h)
    recurrences, as in the JAX package."""
    h = -np.pi + 2.0 * np.pi * np.arange(_LUT_ELEM) / (_LUT_ELEM - 1.0)
    cols = [np.ones_like(h)]
    for k in range(1, K + 1):
        cols += [np.cos(k * h), np.sin(k * h)]
    A = np.stack(cols, -1)
    coef, *_ = np.linalg.lstsq(A, lut, rcond=None)
    return coef.astype(np.float32)


def _fourier_eval(coef, cos_h, sin_h, K: int = _FOURIER_K):
    out = coef[0] + coef[1] * cos_h + coef[2] * sin_h
    ck, sk = cos_h, sin_h
    for k in range(2, K + 1):
        ck, sk = (ck * cos_h - sk * sin_h, sk * cos_h + ck * sin_h)
        out = out + coef[2 * k - 1] * ck + coef[2 * k] * sk
    return out


def _soft_clip(x, soft, hard):
    """soft_clip (colorbalancergb.c:537-543)."""
    norm = torch.clamp(hard - soft, min=1e-12)
    return torch.where(x > soft,
                       soft + (1.0 - torch.exp(-(x - soft) / norm)) * norm,
                       x)


# consts of the chain stage, in order (151 floats; the kernel's layout)
_CONST_ORDER = ("in_mat", "out_mat", "global", "shadows", "highlights",
                "midtones", "midtones_Y", "white_fulcrum", "grey_fulcrum",
                "contrast", "shadows_weight", "highlights_weight",
                "midtones_weight", "mask_grey_fulcrum", "chroma_global",
                "chroma", "saturation_global", "saturation",
                "brilliance_global", "brilliance", "vibrance", "hue_cos",
                "hue_sin", "gamut_f", "L_white")


@register
class ColorBalanceRGB(Op):
    name = "colorbalancergb"
    input_colorspace = Colorspace.WORK_RGB

    def plan(self, ctx: PlanContext, spec_in, p) -> OpPlan:
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=int(p.saturation_formula))

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: ColorBalanceRGBParams):
        rgb_norm = sp.ych_to_grading_np(1.0, 0.0, 0.0)

        def grade(Y, C, H_deg):
            return sp.ych_to_grading_np(1.0, C, math.radians(H_deg)), Y

        g_rgb, g_Y = grade(p.global_Y, p.global_C, p.global_H)
        global_v = (g_rgb - rgb_norm) + rgb_norm * p.global_Y
        s_rgb, _ = grade(p.shadows_Y, p.shadows_C, p.shadows_H)
        shadows_v = 1.0 + (s_rgb - rgb_norm) + p.shadows_Y
        h_rgb, _ = grade(p.highlights_Y, p.highlights_C, p.highlights_H)
        highlights_v = 1.0 + (h_rgb - rgb_norm) + p.highlights_Y
        m_rgb, _ = grade(p.midtones_Y, p.midtones_C, p.midtones_H)
        midtones_v = 1.0 / (1.0 + (m_rgb - rgb_norm))

        shadows_weight = 2.0 + p.shadows_weight * 2.0
        highlights_weight = 2.0 + p.highlights_weight * 2.0
        midtones_weight = (shadows_weight**2 * highlights_weight**2
                           / (shadows_weight**2 + highlights_weight**2))

        work_to_lms = (sp.XYZ_D65_TO_LMS2006 @ cm.XYZ_D50_TO_D65
                       @ cm.XYZ_FROM_WORK)

        return {
            "in_mat": np.float32(work_to_lms),
            # the JzAzBz stage hands back XYZ D65, not LMS
            "out_mat": np.float32(cm.WORK_FROM_XYZ @ cm.XYZ_D65_TO_D50),
            "global": np.float32(global_v),
            "shadows": np.float32(shadows_v),
            "highlights": np.float32(highlights_v),
            "midtones": np.float32(midtones_v),
            "midtones_Y": np.float32(1.0 / (1.0 + p.midtones_Y)),
            "white_fulcrum": np.float32(2.0**p.white_fulcrum),
            "grey_fulcrum": np.float32(max(p.grey_fulcrum, 1e-6)),
            "contrast": np.float32(1.0 + p.contrast),
            "shadows_weight": np.float32(shadows_weight),
            "highlights_weight": np.float32(highlights_weight),
            "midtones_weight": np.float32(midtones_weight),
            "mask_grey_fulcrum": np.float32(p.mask_grey_fulcrum**MASK_EXP),
            "chroma_global": np.float32(p.chroma_global),
            "chroma": np.float32([p.chroma_shadows, p.chroma_midtones,
                                  p.chroma_highlights]),
            "saturation_global": np.float32(p.saturation_global),
            "saturation": np.float32([p.saturation_shadows,
                                      p.saturation_midtones,
                                      p.saturation_highlights]),
            "brilliance_global": np.float32(p.brilliance_global),
            "brilliance": np.float32([p.brilliance_shadows,
                                      p.brilliance_midtones,
                                      p.brilliance_highlights]),
            "vibrance": np.float32(p.vibrance),
            "hue_cos": np.float32(math.cos(math.radians(p.hue_angle))),
            "hue_sin": np.float32(math.sin(math.radians(p.hue_angle))),
            "gamut_f": _fourier_fit(_gamut_lut(
                int(p.saturation_formula),
                cm.XYZ_D50_TO_D65 @ cm.XYZ_FROM_WORK)),
            # dt UCS L* of the white fulcrum (colorbalancergb.c:669)
            "L_white": np.float32(
                2.098883786377 * (2.0 ** p.white_fulcrum) ** 0.631651345306265
                / ((2.0 ** p.white_fulcrum) ** 0.631651345306265
                   + 1.12426773749357)),
        }

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        return _pixel(x, c, plan.static)

    def pointwise_spec(self, plan, ctx):
        formula = plan.static
        # after the consts: the inverse JzAzBz matrices, row-major
        extra = tuple(float(v) for v in sp.JZ_AI.reshape(-1)) \
            + tuple(float(v) for v in sp._JZ_MI.reshape(-1))
        return PointwiseSpec(fn=lambda x, c: _pixel(x, c, formula),
                             opcode=OP_COLORBALANCERGB, consts=_CONST_ORDER,
                             ints=(formula,), extra=extra)


def _opacities(x, c):
    """sigmoid zone masks (colorbalancergb.c:509-534); x = Y^0.41."""
    off = x - c["mask_grey_fulcrum"]
    off_n = off / c["mask_grey_fulcrum"]
    alpha = 1.0 / (1.0 + torch.exp(off_n * c["shadows_weight"]))
    beta = 1.0 / (1.0 + torch.exp(-off_n * c["highlights_weight"]))
    ac, bc = 1.0 - alpha, 1.0 - beta
    gamma = torch.exp(-off**2 * c["midtones_weight"] / 4.0) * ac**2 \
        * bc**2 * 8.0
    return (alpha, gamma, beta), (ac, 1.0 - gamma, bc)


def _pixel(x, c, formula=SAT_JZAZBZ):
    rgb = torch.clamp(x, min=0.0)
    lms = apply_matrix(rgb, c["in_mat"])
    yrg = sp.lms_to_yrg(lms)
    Y = torch.clamp(yrg[0], min=0.0)

    (op_s, op_m, op_h), (cp_s, cp_m, cp_h) = _opacities(
        torch.clamp(Y, min=1e-12) ** MASK_EXP, c)

    # hue rotation + chroma/vibrance in the Yrg chromaticity plane
    r_c = yrg[1] - sp.YRG_WHITE_R
    g_c = yrg[2] - sp.YRG_WHITE_G
    r_rot = c["hue_cos"] * r_c - c["hue_sin"] * g_c
    g_rot = c["hue_sin"] * r_c + c["hue_cos"] * g_c
    chroma_in = torch.sqrt(r_rot**2 + g_rot**2)
    inv_c = torch.where(chroma_in > 0.0,
                        1.0 / torch.clamp(chroma_in, min=1e-20), 0.0)
    cos_h = r_rot * inv_c
    sin_h = g_rot * inv_c
    ch = c["chroma"]
    chroma_boost = (c["chroma_global"] + op_s * ch[0] + op_m * ch[1]
                    + op_h * ch[2])
    vib = c["vibrance"] * (1.0 - torch.clamp(chroma_in, min=0.0)
                           ** torch.abs(c["vibrance"]))
    chroma_factor = torch.clamp(1.0 + chroma_boost + vib, min=0.0)
    chroma_out = chroma_in * chroma_factor
    # gamut guards: keep (r, g, b) of the chromaticity positive
    safe_cos = torch.where(torch.abs(cos_h) > 1e-9, cos_h, 1e-9)
    safe_sin = torch.where(torch.abs(sin_h) > 1e-9, sin_h, 1e-9)
    r_lim = fdiv(-sp.YRG_WHITE_R, safe_cos)
    g_lim = fdiv(-sp.YRG_WHITE_G, safe_sin)
    s_lim = fdiv(1.0 - sp.YRG_WHITE_R - sp.YRG_WHITE_G, safe_cos + safe_sin)
    chroma_out = torch.where(chroma_out * cos_h + sp.YRG_WHITE_R < 0.0,
                             torch.minimum(r_lim, chroma_out), chroma_out)
    chroma_out = torch.where(chroma_out * sin_h + sp.YRG_WHITE_G < 0.0,
                             torch.minimum(g_lim, chroma_out), chroma_out)
    chroma_out = torch.where(
        (chroma_out * cos_h + sp.YRG_WHITE_R)
        + (chroma_out * sin_h + sp.YRG_WHITE_G) > 1.0,
        torch.minimum(s_lim, chroma_out), chroma_out)
    yrg = torch.stack([Y, chroma_out * cos_h + sp.YRG_WHITE_R,
                       chroma_out * sin_h + sp.YRG_WHITE_G])

    # 4-way grading in grading RGB
    grading = sp.lms_to_grading(sp.yrg_to_lms(yrg))
    gl, sh, hl, mt = (c["global"], c["shadows"], c["highlights"],
                      c["midtones"])
    wf = c["white_fulcrum"]
    chans = []
    for i in range(3):
        g = grading[i] + gl[i]
        g = g * (cp_h * (cp_s + op_s * sh[i]) + op_h * hl[i])
        chans.append(torch.sign(g) * (torch.abs(g) / wf) ** mt[i] * wf)
    grading = torch.stack(chans)

    yrg = sp.lms_to_yrg(sp.grading_to_lms(grading))
    Y2 = torch.clamp(yrg[0] / wf, min=0.0) ** c["midtones_Y"] * wf
    Y2 = c["grey_fulcrum"] * torch.clamp(
        Y2 / c["grey_fulcrum"], min=0.0) ** c["contrast"]
    yrg = torch.stack([Y2, yrg[1], yrg[2]])
    xyz = apply_matrix(sp.yrg_to_lms(yrg), sp.LMS2006_TO_XYZ_D65.tolist())

    sat = c["saturation"]
    bri = c["brilliance"]
    boost_b = c["brilliance_global"] + op_s * bri[0] \
        + op_m * bri[1] + op_h * bri[2]
    boost_s = c["saturation_global"] + op_s * sat[0] + op_m * sat[1] \
        + op_h * sat[2]

    if formula == SAT_DTUCS:
        xyz_out = _saturation_dtucs(xyz, c, boost_s, boost_b)
    else:
        xyz_out = _saturation_jzazbz(xyz, c, boost_s, boost_b)
    out = apply_matrix(torch.clamp(xyz_out, min=0.0), c["out_mat"])
    return torch.clamp(out, min=0.0)


def _saturation_jzazbz(xyz, c, boost_s, boost_b):
    """JzAzBz saturation/brilliance + per-hue gamut soft-clip + LMS'
    clamp (colorbalancergb.c:764-840)."""
    jab = sp.xyz_to_jzazbz(torch.clamp(xyz, min=0.0))
    Jz = jab[0]
    Cz = torch.sqrt(jab[1] ** 2 + jab[2] ** 2)
    inv_cz = torch.where(Cz > 0.0, 1.0 / torch.clamp(Cz, min=1e-20), 0.0)
    cos_H = jab[1] * inv_cz
    sin_H = jab[2] * inv_cz
    T = atan_pos(Cz, Jz)
    hyp = torch.sqrt(Jz * Jz + Cz * Cz)
    inv_h = torch.where(hyp > 0.0, 1.0 / torch.clamp(hyp, min=1e-20), 0.0)
    sin_T = Cz * inv_h
    cos_T = torch.where(hyp > 0.0, Jz * inv_h, 1.0)
    S0 = Jz * cos_T + Cz * sin_T
    O1 = S0 * torch.minimum(torch.maximum(T * boost_s, -T),
                            math.pi / 2.0 - T)
    S1 = torch.clamp(S0 * (1.0 + boost_b), min=0.0)
    Jz2 = torch.clamp(S1 * cos_T - O1 * sin_T, min=0.0)
    Cz2 = torch.clamp(S1 * sin_T + O1 * cos_T, min=0.0)

    # per-hue gamut soft-clip (colorbalancergb.c:798-807)
    max_sat_h = torch.clamp(_fourier_eval(c["gamut_f"], cos_H, sin_H),
                            min=1e-6)
    sat_px = torch.where(
        Jz2 > 0.0,
        _soft_clip(Cz2 / torch.clamp(Jz2, min=1e-20), 0.8 * max_sat_h,
                   max_sat_h),
        max_sat_h)
    max_C_at_sat = Jz2 * sat_px
    max_J_at_sat = torch.where(sat_px > 0.0,
                               Cz2 / torch.clamp(sat_px, min=1e-20), Jz2)
    Jz2 = 0.5 * (Jz2 + max_J_at_sat)
    Cz2 = 0.5 * (Cz2 + max_C_at_sat)

    # analytic clamps: LMS' rows of the inverse Iz(Az,Bz) matrix must
    # stay positive (colorbalancergb.c:810-838)
    d0 = 1.6295499532821566e-11
    dd = -0.56
    Iz = Jz2 + d0
    Iz = torch.clamp(Iz / (1.0 + dd - dd * Iz), min=0.0)
    AI = sp.JZ_AI.tolist()
    max_C = Cz2
    for row in range(3):
        denom = AI[row][1] * cos_H + AI[row][2] * sin_H
        lms_test = Iz * AI[row][0] + Cz2 * denom
        lim = -Iz * AI[row][0] / torch.where(torch.abs(denom) > 1e-12,
                                             denom, 1e-12)
        max_C = torch.where(lms_test < 0.0, torch.minimum(lim, max_C),
                            max_C)

    jab_out = torch.stack([Jz2, max_C * cos_H, max_C * sin_H])
    return sp.jzazbz_to_xyz(jab_out)


def _saturation_dtucs(xyz, c, boost_s, boost_b):
    """dt UCS 22 saturation/brilliance (colorbalancergb.c:841-884):
    HCB-plane rotation with soft-clipped saturation gain, per-hue
    colorfulness boundary, HSB soft-clip."""
    L_white = c["L_white"]
    X, Y, Z = xyz[0], torch.clamp(xyz[1], min=0.0), xyz[2]
    ssum = torch.clamp(X + Y + Z, min=1e-12)
    xx_, yy_ = X / ssum, Y / ssum
    # xyY -> dt UCS UV* prime (colorspaces_inline_conversions.h:1276)
    UVD = [(-0.783941002840055 * xx_ + 0.277512987809202 * yy_
            + 0.153836578598858),
           (0.745273540913283 * xx_ - 0.205375866083878 * yy_
            - 0.165478376301988),
           (0.318707282433486 * xx_ + 2.16743692732158 * yy_
            + 0.291320554395942)]
    U = UVD[0] / UVD[2]
    V = UVD[1] / UVD[2]
    Us = 1.39656225667 * U / (torch.abs(U) + 1.49217352929)
    Vs = 1.4513954287 * V / (torch.abs(V) + 1.52488637914)
    Up = -1.124983854323892 * Us - 0.980483721769325 * Vs
    Vp = 1.86323315098672 * Us + 1.971853092390862 * Vs
    M2 = Up * Up + Vp * Vp
    M = torch.sqrt(M2)
    inv_m = torch.where(M > 0.0, 1.0 / torch.clamp(M, min=1e-20), 0.0)
    cos_H = torch.where(M > 0.0, Up * inv_m, 1.0)
    sin_H = Vp * inv_m
    Yh = torch.clamp(Y, min=1e-12) ** 0.631651345306265
    L_star = 2.098883786377 * Yh / (Yh + 1.12426773749357)
    J = L_star / L_white
    C = 15.932993652962535 * L_star ** 0.6523997524738018 \
        * M2 ** 0.6007557017508491 / L_white
    B = J * (C ** 1.33654221029386 + 1.0)

    radius = torch.sqrt(C * C + B * B)
    inv_r = torch.where(radius > 0.0, 1.0 / torch.clamp(radius, min=1e-20),
                        0.0)
    sin_T = C * inv_r
    cos_T = B * inv_r
    P = torch.clamp(C, min=1e-30)
    W = sin_T * C + cos_T * B
    a = torch.clamp(1.0 + boost_s, min=0.0)
    b = torch.clamp(1.0 + boost_b, min=0.0)
    max_a = torch.sqrt(P * P + W * W) / P
    a = _soft_clip(a, 0.5 * max_a, max_a)
    P_p = (a - 1.0) * P
    W_p = torch.sqrt(torch.clamp(P * P * (1.0 - a * a), min=0.0)
                     + W * W) * b
    C2 = torch.clamp(cos_T * P_p + sin_T * W_p, min=0.0)
    B2 = torch.clamp(-sin_T * P_p + cos_T * W_p, min=0.0)
    J2 = B2 / (C2 ** 1.33654221029386 + 1.0)

    # per-hue colorfulness boundary (the LUT stores M^2)
    maxM2 = torch.clamp(_fourier_eval(c["gamut_f"], cos_H, sin_H),
                        min=1e-12)
    max_chroma = 15.932993652962535 \
        * torch.clamp(J2 * L_white, min=1e-12) ** 0.6523997524738018 \
        * maxM2 ** 0.6007557017508491 / L_white
    B_bound = J2 * (max_chroma ** 1.33654221029386 + 1.0)
    S_bound = max_chroma / torch.clamp(B_bound, min=1e-20)
    S = torch.where(B2 > 0.0, C2 / torch.clamp(B2, min=1e-20), 0.0)
    S = _soft_clip(S, 0.8 * S_bound, S_bound)
    C3 = S * B2
    J3 = B2 / (C3 ** 1.33654221029386 + 1.0)

    # dt UCS JCH -> xyY (colorspaces_inline_conversions.h:1344-1381)
    L3 = J3 * L_white
    M3 = torch.clamp(
        C3 * L_white / (15.932993652962535
                        * torch.clamp(L3, min=1e-12)
                        ** 0.6523997524738018),
        min=0.0) ** 0.8322850678616855
    Up3 = M3 * cos_H
    Vp3 = M3 * sin_H
    Us3 = -5.037522385190711 * Up3 - 2.504856328185843 * Vp3
    Vs3 = 4.760029407436461 * Up3 + 2.874012963239247 * Vp3
    U3 = -1.49217352929 * Us3 / (torch.abs(Us3) - 1.39656225667)
    V3 = -1.52488637914 * Vs3 / (torch.abs(Vs3) - 1.4513954287)
    xyD = [(0.167171472114775 * U3 + 0.141299802443708 * V3
            - 0.00801531300850582),
           (-0.150959086409163 * U3 - 0.155185060382272 * V3
            - 0.00843312433578007),
           (0.940254742367256 * U3 + 1.0 * V3 - 0.0256325967652889)]
    xd = xyD[0] / xyD[2]
    yd = xyD[1] / xyD[2]
    Y3 = torch.clamp(
        1.12426773749357 * L3
        / torch.clamp(2.098883786377 - L3, min=1e-9),
        min=0.0) ** 1.5831518565279648
    safe_y = torch.clamp(yd, min=1e-9)
    X3 = xd * Y3 / safe_y
    Z3 = (1.0 - xd - yd) * Y3 / safe_y
    return torch.stack([X3, Y3, Z3])
