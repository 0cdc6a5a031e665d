"""Illuminant models: CCT -> chromaticity for daylight (CIE D) and
Planckian (blackbody) loci, plus standard illuminants.

Reference: `ansel/src/pixel/illuminants.h` (illuminant_to_xy and
friends used by channelmixerrgb/temperature).  The loci below are the
standard CIE formulations, evaluated host-side at commit time.
"""

from __future__ import annotations

import math

# dt_illuminant_t (reference src/pixel/illuminants.h)
ILLUMINANT_PIPE = 0      # pipeline white (no adaptation)
ILLUMINANT_A = 1
ILLUMINANT_D = 2
ILLUMINANT_E = 3
ILLUMINANT_F = 4
ILLUMINANT_LED = 5
ILLUMINANT_BB = 6
ILLUMINANT_CUSTOM = 7
ILLUMINANT_DETECT_SURFACES = 8
ILLUMINANT_DETECT_EDGES = 9
ILLUMINANT_CAMERA = 10

XY_A = (0.44757, 0.40745)
XY_E = (1.0 / 3.0, 1.0 / 3.0)
XY_D50 = (0.34567, 0.35850)
XY_D65 = (0.31271, 0.32902)

# CIE F series (fluorescent) chromaticities F1..F12
XY_F = [
    (0.3131, 0.3371), (0.3721, 0.3751), (0.4091, 0.3941), (0.4402, 0.4031),
    (0.3138, 0.3452), (0.3779, 0.3882), (0.3129, 0.3292), (0.3458, 0.3586),
    (0.3741, 0.3727), (0.3458, 0.3588), (0.3805, 0.3769), (0.4370, 0.4042),
]


def daylight_xy(cct: float):
    """CIE daylight locus (valid 4000K..25000K)."""
    t = min(max(cct, 4000.0), 25000.0)
    if t <= 7000.0:
        x = (-4.6070e9 / t**3 + 2.9678e6 / t**2 + 0.09911e3 / t + 0.244063)
    else:
        x = (-2.0064e9 / t**3 + 1.9018e6 / t**2 + 0.24748e3 / t + 0.237040)
    y = -3.0 * x * x + 2.87 * x - 0.275
    return x, y


def blackbody_xy(cct: float):
    """Planckian locus approximation (Kim et al. cubic spline, 1667-25000K)."""
    t = min(max(cct, 1667.0), 25000.0)
    if t <= 4000.0:
        x = (-0.2661239e9 / t**3 - 0.2343589e6 / t**2
             + 0.8776956e3 / t + 0.179910)
    else:
        x = (-3.0258469e9 / t**3 + 2.1070379e6 / t**2
             + 0.2226347e3 / t + 0.240390)
    if t <= 2222.0:
        y = (-1.1063814 * x**3 - 1.34811020 * x**2 + 2.18555832 * x
             - 0.20219683)
    elif t <= 4000.0:
        y = (-0.9549476 * x**3 - 1.37418593 * x**2 + 2.09137015 * x
             - 0.16748867)
    else:
        y = (3.0817580 * x**3 - 5.87338670 * x**2 + 3.75112997 * x
             - 0.37001483)
    return x, y


def illuminant_to_xy(kind: int, temperature: float = 5003.0,
                     custom_x: float = 1.0 / 3.0, custom_y: float = 1.0 / 3.0,
                     fluo: int = 2, pipe_white=None):
    if kind == ILLUMINANT_PIPE:
        if pipe_white is None:
            # pipeline white = D50, like the reference (illuminant.h
            # DT_ILLUMINANT_PIPE -> D50 PCS white)
            from .matrices import PIPE_WHITE_XY

            pipe_white = PIPE_WHITE_XY
        return pipe_white
    if kind == ILLUMINANT_A:
        return XY_A
    if kind == ILLUMINANT_D:
        return daylight_xy(temperature)
    if kind == ILLUMINANT_E:
        return XY_E
    if kind == ILLUMINANT_F:
        return XY_F[min(max(fluo, 0), 11)]
    if kind == ILLUMINANT_BB:
        return blackbody_xy(temperature)
    # CUSTOM / CAMERA / DETECT_* -> stored chromaticity
    return (custom_x, custom_y)
