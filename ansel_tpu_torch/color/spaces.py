"""Perceptual/grading color spaces used by the scene-referred color ops.

Torch counterparts of `ansel_tpu/color/spaces.py` (reference
`ansel/src/common/colorspaces_inline_conversions.h`: CIE-2006 LMS
:902-910, Filmlight grading RGB :976-1006, Kirk Yrg :1013-1063, JzAzBz :672-853), in the reference's operand order.
"""

from __future__ import annotations

import numpy as np
import torch

from .transforms import apply_matrix, fdiv

# CIE 2006 cone fundamentals <-> XYZ D65 (colorspaces_inline_conversions.h:902)
XYZ_D65_TO_LMS2006 = np.array([
    [0.257085, 0.859943, -0.031061],
    [-0.394427, 1.175800, 0.106423],
    [0.064856, -0.076250, 0.559067],
])
LMS2006_TO_XYZ_D65 = np.array([
    [1.80794659, -1.29971660, 0.34785879],
    [0.61783960, 0.39595453, -0.04104687],
    [-0.12546960, 0.20478038, 1.74274183],
])

# Filmlight grading RGB <-> LMS (colorspaces_inline_conversions.h:979-1001)
GRADING_TO_LMS = np.array([
    [0.95, 0.38, 0.00],
    [0.05, 0.62, 0.03],
    [0.00, 0.00, 0.97],
])
LMS_TO_GRADING = np.array([
    [1.0877193, -0.66666667, 0.02061856],
    [-0.0877193, 1.66666667, -0.05154639],
    [0.0, 0.0, 1.03092784],
])

# Yrg white point chroma coordinates (D65 in Kirk Yrg)
YRG_WHITE_R = 0.21902143
YRG_WHITE_G = 0.54371398


def lms_to_yrg(lms: torch.Tensor) -> torch.Tensor:
    Y = 0.68990272 * lms[0] + 0.34832189 * lms[1]
    a = lms[0] + lms[1] + lms[2]
    inv_a = torch.where(a == 0.0, 0.0, 1.0 / a)
    norm = lms * inv_a[None]
    rgb = apply_matrix(norm, LMS_TO_GRADING.tolist())
    return torch.stack([Y, rgb[0], rgb[1]])


def yrg_to_lms(yrg: torch.Tensor) -> torch.Tensor:
    r, g = yrg[1], yrg[2]
    b = 1.0 - r - g
    rgb = torch.stack([r, g, b])
    lms = apply_matrix(rgb, GRADING_TO_LMS.tolist())
    denom = 0.68990272 * lms[0] + 0.34832189 * lms[1]
    a = torch.where(denom == 0.0, 0.0, yrg[0] / denom)
    return lms * a[None]


def lms_to_grading(lms: torch.Tensor) -> torch.Tensor:
    return apply_matrix(lms, LMS_TO_GRADING.tolist())


def grading_to_lms(rgb: torch.Tensor) -> torch.Tensor:
    return apply_matrix(rgb, GRADING_TO_LMS.tolist())


def ych_to_grading_np(Y: float, C: float, h_rad: float) -> np.ndarray:
    """Host-side Ych -> grading RGB (commit-time constants)."""
    r = C * np.cos(h_rad) + YRG_WHITE_R
    g = C * np.sin(h_rad) + YRG_WHITE_G
    b = 1.0 - r - g
    lms = GRADING_TO_LMS @ np.array([r, g, b])
    denom = 0.68990272 * lms[0] + 0.34832189 * lms[1]
    lms = lms * (Y / denom if denom != 0 else 0.0)
    return LMS_TO_GRADING @ lms


# --- JzAzBz ------------------------------------------------------------------

_JZ_B, _JZ_G = 1.15, 0.66
_JZ_C1, _JZ_C2, _JZ_C3 = 0.8359375, 18.8515625, 18.6875
_JZ_N, _JZ_P = 0.159301758, 134.034375
_JZ_D, _JZ_D0 = -0.56, 1.6295499532821566e-11
_JZ_M = np.array([
    [0.41478972, 0.579999, 0.0146480],
    [-0.2015100, 1.120649, 0.0531008],
    [-0.0166008, 0.264800, 0.6684799],
])
_JZ_A = np.array([
    [0.5, 0.5, 0.0],
    [3.524000, -4.066708, 0.542708],
    [0.199076, 1.096799, -1.295875],
])
_JZ_MI = np.linalg.inv(_JZ_M)
JZ_AI = np.linalg.inv(_JZ_A)


def xyz_to_jzazbz(xyz: torch.Tensor) -> torch.Tensor:
    X, Y, Z = xyz[0], xyz[1], xyz[2]
    Xp = _JZ_B * X - (_JZ_B - 1.0) * Z
    Yp = _JZ_G * Y - (_JZ_G - 1.0) * X
    lms = apply_matrix(torch.stack([Xp, Yp, Z]), _JZ_M.tolist())
    y = torch.clamp(fdiv(lms, 10000.0), min=0.0) ** _JZ_N
    pq = ((_JZ_C1 + _JZ_C2 * y) / (1.0 + _JZ_C3 * y)) ** _JZ_P
    iab = apply_matrix(pq, _JZ_A.tolist())
    Jz = torch.clamp(((1.0 + _JZ_D) * iab[0]) / (1.0 + _JZ_D * iab[0])
                     - _JZ_D0, min=0.0)
    return torch.stack([Jz, iab[1], iab[2]])


def jzazbz_to_xyz(jab: torch.Tensor) -> torch.Tensor:
    Iz = jab[0] + _JZ_D0
    Iz = torch.clamp(Iz / (1.0 + _JZ_D - _JZ_D * Iz), min=0.0)
    iab = torch.stack([Iz, jab[1], jab[2]])
    pq = apply_matrix(iab, JZ_AI.tolist())
    y = torch.clamp(pq, min=0.0) ** (1.0 / _JZ_P)
    lms = 10000.0 * torch.clamp(
        (_JZ_C1 - y) / (_JZ_C3 * y - _JZ_C2), min=0.0) ** (1.0 / _JZ_N)
    xyzp = apply_matrix(lms, _JZ_MI.tolist())
    X = fdiv(xyzp[0] + (_JZ_B - 1.0) * xyzp[2], _JZ_B)
    Y = fdiv(xyzp[1] + (_JZ_G - 1.0) * X, _JZ_G)
    return torch.stack([X, Y, xyzp[2]])
