"""Host colour math of the plain reference: profile matrices from
chromaticities, chromatic adaptation, the CIE 2006 LMS / Kirk Yrg spaces
and filmic's AgX brackets, in float64 numpy.

Written from darktable/ansel's published formulas
(src/common/colorspaces_inline_conversions.h, src/iop/filmicrgb.c
filmic_agx_prepare_bracket, src/iop/channelmixerrgb.c) and frozen here;
nothing of the program under test is imported.
"""

from __future__ import annotations

import math

import numpy as np

WP_D65 = (0.3127, 0.3290)
WP_D50 = (0.34567, 0.35850)

PRIMARIES = {
    "srgb": (0.640, 0.330, 0.300, 0.600, 0.150, 0.060),
    "rec2020": (0.708, 0.292, 0.170, 0.797, 0.131, 0.046),
}

BRADFORD = np.array([[0.8951, 0.2664, -0.1614],
                     [-0.7502, 1.7135, 0.0367],
                     [0.0389, -0.0685, 1.0296]])
CAT16 = np.array([[0.401288, 0.650173, -0.051461],
                  [-0.250268, 1.204414, 0.045854],
                  [-0.002079, 0.048952, 0.953127]])


def xy_to_XYZ(x, y, Y=1.0):
    return np.array([x * Y / y, Y, (1.0 - x - y) * Y / y])


def rgb_to_xyz(primaries, white_xy):
    xr, yr, xg, yg, xb, yb = primaries
    P = np.array([[xr / yr, xg / yg, xb / yb],
                  [1.0, 1.0, 1.0],
                  [(1 - xr - yr) / yr, (1 - xg - yg) / yg,
                   (1 - xb - yb) / yb]])
    S = np.linalg.solve(P, xy_to_XYZ(*white_xy))
    return P * S[None, :]


def adapt(src_XYZ, dst_XYZ, cone=BRADFORD):
    """von Kries adaptation XYZ_src -> XYZ_dst in the cone space `cone`."""
    s, d = cone @ src_XYZ, cone @ dst_XYZ
    return np.linalg.inv(cone) @ np.diag(d / s) @ cone


def profile_to_xyz(name, white_xy):
    """A D65 RGB profile -> XYZ adapted (Bradford) to `white_xy`."""
    M = rgb_to_xyz(PRIMARIES[name], WP_D65)
    if white_xy != WP_D65:
        M = adapt(xy_to_XYZ(*WP_D65), xy_to_XYZ(*white_xy)) @ M
    return M


# the pipeline's working space: linear Rec2020 on the D50 PCS white
PIPE_WHITE_XYZ = xy_to_XYZ(*WP_D50)
XYZ_FROM_WORK = profile_to_xyz("rec2020", WP_D50)
WORK_FROM_XYZ = np.linalg.inv(XYZ_FROM_WORK)
WORK_Y = XYZ_FROM_WORK[1].copy()
XYZ_D50_TO_D65 = adapt(xy_to_XYZ(*WP_D50), xy_to_XYZ(*WP_D65), CAT16)
XYZ_D65_TO_D50 = np.linalg.inv(XYZ_D50_TO_D65)


def cam_to_work(cam_to_xyz):
    """Camera RGB -> work RGB with camera white mapped to work white."""
    M = WORK_FROM_XYZ @ np.asarray(cam_to_xyz, np.float64).reshape(3, 3)
    return M / (M @ np.ones(3))[:, None]


def work_to_display(name):
    """Work RGB -> a display profile, both on the D65 white."""
    return np.linalg.inv(rgb_to_xyz(PRIMARIES[name], WP_D65)) \
        @ rgb_to_xyz(PRIMARIES["rec2020"], WP_D65)


def daylight_xy(cct):
    """CIE daylight locus."""
    t = min(max(cct, 4000.0), 25000.0)
    if t <= 7000.0:
        x = -4.6070e9 / t**3 + 2.9678e6 / t**2 + 0.09911e3 / t + 0.244063
    else:
        x = -2.0064e9 / t**3 + 1.9018e6 / t**2 + 0.24748e3 / t + 0.237040
    return x, -3.0 * x * x + 2.87 * x - 0.275


# CIE 2006 LMS and the Filmlight grading RGB of Kirk's Yrg
XYZ_D65_TO_LMS2006 = np.array([[0.257085, 0.859943, -0.031061],
                               [-0.394427, 1.175800, 0.106423],
                               [0.064856, -0.076250, 0.559067]])
LMS2006_TO_XYZ_D65 = np.array([[1.80794659, -1.29971660, 0.34785879],
                               [0.61783960, 0.39595453, -0.04104687],
                               [-0.12546960, 0.20478038, 1.74274183]])
GRADING_TO_LMS = np.array([[0.95, 0.38, 0.00],
                           [0.05, 0.62, 0.03],
                           [0.00, 0.00, 0.97]])
LMS_TO_GRADING = np.array([[1.0877193, -0.66666667, 0.02061856],
                           [-0.0877193, 1.66666667, -0.05154639],
                           [0.0, 0.0, 1.03092784]])
YRG_WHITE = (0.21902143, 0.54371398)
CIE_Y_2006 = 1.05785528


def _xyz_to_yrg(xyz):
    lms = XYZ_D65_TO_LMS2006 @ xyz
    rgb = LMS_TO_GRADING @ (lms / lms.sum())
    return np.array([0.68990272 * lms[0] + 0.34832189 * lms[1],
                     rgb[0], rgb[1]])


def _yrg_to_xyz(yrg):
    lms = GRADING_TO_LMS @ np.array([yrg[1], yrg[2], 1.0 - yrg[1] - yrg[2]])
    lms = lms * (yrg[0] / (0.68990272 * lms[0] + 0.34832189 * lms[1]))
    return LMS2006_TO_XYZ_D65 @ lms


# AgX bracket anchors of colour science v8, medium bleach: inset, rotation,
# outset, rotation (filmicrgb.c filmic_agx_prepare_bracket)
AGX_V8 = ((0.6509540, 0.7488775, 0.3517703),
          (0.0278602, 0.1214671, -0.0228829),
          (0.793082, 0.815169, 0.460318),
          (-0.0053781, 0.1187604, -0.0794801))


def _displaced(inset, rotation):
    """Work RGB -> the primaries pulled toward white by `inset` and
    rotated in Yrg by `rotation`, white preserved."""
    m_in = XYZ_D50_TO_D65 @ XYZ_FROM_WORK
    white = m_in @ np.ones(3)
    w_yrg = _xyz_to_yrg(white)
    P = np.zeros((3, 3))
    for i in range(3):
        p = _xyz_to_yrg(m_in[:, i])
        dr, dg = p[1] - w_yrg[1], p[2] - w_yrg[2]
        k = 1.0 - min(max(inset[i], 0.0), 0.9)
        ca, sa = math.cos(rotation[i]), math.sin(rotation[i])
        P[:, i] = _yrg_to_xyz([p[0], w_yrg[1] + k * (ca * dr - sa * dg),
                               w_yrg[2] + k * (sa * dr + ca * dg)])
    P = P * np.linalg.solve(P, white)[None, :]
    return WORK_FROM_XYZ @ XYZ_D65_TO_D50 @ P


def agx_matrices():
    """-> (inset, outset, work -> LMS2006, LMS2006 -> work)."""
    ia, ir, oa, orot = AGX_V8
    inset = _displaced(ia, ir)
    outset = np.linalg.inv(_displaced(oa, orot))
    to_lms = XYZ_D65_TO_LMS2006 @ XYZ_D50_TO_D65 @ XYZ_FROM_WORK
    from_lms = WORK_FROM_XYZ @ XYZ_D65_TO_D50 @ LMS2006_TO_XYZ_D65
    return inset, outset, to_lms, from_lms
