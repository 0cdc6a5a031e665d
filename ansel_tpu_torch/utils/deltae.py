"""CIEDE2000 delta-E — the acceptance metric of the reference integration
suite (`ansel/tests/integration/deltae`: sRGB -> Lab ->
delta_E CIE2000; gates MAX_DELTA_E = 2.3, MAX_AVG = 2.3/3).

NumPy implementation of the Sharma/Wu/Dalal CIEDE2000 formulation —
independent of the pipeline code so it can gate it.
"""

from __future__ import annotations

import numpy as np

MAX_DELTA_E = 2.3
MAX_AVG_DELTA_E = MAX_DELTA_E / 3.0

_D65 = (0.95047, 1.0, 1.08883)

_M_SRGB_TO_XYZ = np.array([
    [0.4124564, 0.3575761, 0.1804375],
    [0.2126729, 0.7151522, 0.0721750],
    [0.0193339, 0.1191920, 0.9503041]])


def srgb_to_lab(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) display sRGB [0,1] -> CIE Lab (D65)."""
    rgb = np.clip(np.asarray(rgb, np.float64), 0.0, 1.0)
    lin = np.where(rgb <= 0.04045, rgb / 12.92,
                   ((rgb + 0.055) / 1.055) ** 2.4)
    xyz = lin @ _M_SRGB_TO_XYZ.T
    xr = xyz / np.asarray(_D65)
    eps, kappa = 216.0 / 24389.0, 24389.0 / 27.0
    f = np.where(xr > eps, np.cbrt(xr), (kappa * xr + 16.0) / 116.0)
    L = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return np.stack([L, a, b], axis=-1)


def ciede2000(lab1: np.ndarray, lab2: np.ndarray) -> np.ndarray:
    """Per-pixel CIEDE2000 between two (..., 3) Lab arrays."""
    L1, a1, b1 = lab1[..., 0], lab1[..., 1], lab1[..., 2]
    L2, a2, b2 = lab2[..., 0], lab2[..., 1], lab2[..., 2]
    C1 = np.hypot(a1, b1)
    C2 = np.hypot(a2, b2)
    Cbar = 0.5 * (C1 + C2)
    G = 0.5 * (1.0 - np.sqrt(Cbar**7 / (Cbar**7 + 25.0**7)))
    ap1 = (1.0 + G) * a1
    ap2 = (1.0 + G) * a2
    Cp1 = np.hypot(ap1, b1)
    Cp2 = np.hypot(ap2, b2)
    hp1 = np.degrees(np.arctan2(b1, ap1)) % 360.0
    hp2 = np.degrees(np.arctan2(b2, ap2)) % 360.0

    dL = L2 - L1
    dC = Cp2 - Cp1
    dh = hp2 - hp1
    dh = np.where(dh > 180.0, dh - 360.0, dh)
    dh = np.where(dh < -180.0, dh + 360.0, dh)
    dh = np.where((Cp1 * Cp2) == 0.0, 0.0, dh)
    dH = 2.0 * np.sqrt(Cp1 * Cp2) * np.sin(np.radians(dh) / 2.0)

    Lbar = 0.5 * (L1 + L2)
    Cpbar = 0.5 * (Cp1 + Cp2)
    hsum = hp1 + hp2
    hdiff = np.abs(hp1 - hp2)
    hbar = np.where(hdiff <= 180.0, 0.5 * hsum,
                    np.where(hsum < 360.0, 0.5 * (hsum + 360.0),
                             0.5 * (hsum - 360.0)))
    hbar = np.where((Cp1 * Cp2) == 0.0, hsum, hbar)

    T = (1.0 - 0.17 * np.cos(np.radians(hbar - 30.0))
         + 0.24 * np.cos(np.radians(2.0 * hbar))
         + 0.32 * np.cos(np.radians(3.0 * hbar + 6.0))
         - 0.20 * np.cos(np.radians(4.0 * hbar - 63.0)))
    dtheta = 30.0 * np.exp(-(((hbar - 275.0) / 25.0) ** 2))
    RC = 2.0 * np.sqrt(Cpbar**7 / (Cpbar**7 + 25.0**7))
    SL = 1.0 + 0.015 * (Lbar - 50.0) ** 2 / np.sqrt(
        20.0 + (Lbar - 50.0) ** 2)
    SC = 1.0 + 0.045 * Cpbar
    SH = 1.0 + 0.015 * Cpbar * T
    RT = -np.sin(np.radians(2.0 * dtheta)) * RC

    return np.sqrt((dL / SL) ** 2 + (dC / SC) ** 2 + (dH / SH) ** 2
                   + RT * (dC / SC) * (dH / SH))


def deltae_stats(rgb_expected: np.ndarray, rgb_output: np.ndarray):
    """(3, H, W) or (H, W, 3) pairs -> (max, mean, std) CIEDE2000."""
    a = np.asarray(rgb_expected)
    b = np.asarray(rgb_output)
    if a.ndim == 3 and a.shape[0] == 3:
        a = a.transpose(1, 2, 0)
    if b.ndim == 3 and b.shape[0] == 3:
        b = b.transpose(1, 2, 0)
    dE = ciede2000(srgb_to_lab(a), srgb_to_lab(b))
    return float(dE.max()), float(dE.mean()), float(dE.std())
