"""Perceptual/grading color spaces used by the scene-referred color ops.

Torch counterparts of `ansel_tpu/color/spaces.py` (reference
`ansel/src/common/colorspaces_inline_conversions.h`: CIE-2006 LMS
:902-910, Filmlight grading RGB :976-1006, Kirk Yrg :1013-1063).  JzAzBz
is not on any ported path and waits for the op that needs it.
"""

from __future__ import annotations

import numpy as np
import torch

from .transforms import apply_matrix

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
