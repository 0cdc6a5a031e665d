"""Color space matrix machinery.

Replaces the reference's LittleCMS2 + inline conversion header stack
(`ansel/src/common/colorspaces.c`,
`src/common/colorspaces_inline_conversions.h`) for the matrix+TRC profile
class.  All RGB<->XYZ matrices are *derived* from primaries/white-point
chromaticities at import time rather than hard-coded, and chromatic
adaptation uses the Bradford CAT — the same linear algebra the reference
evaluates via LCMS for matrix profiles.

Everything here is host-side numpy; the jitted pipeline consumes the
resulting 3x3 matrices as constants.
"""

from __future__ import annotations

import numpy as np

# --- white points (CIE xy chromaticities) -----------------------------------
WP_D65 = (0.3127, 0.3290)
WP_D50 = (0.34567, 0.35850)

# --- primaries: (xr, yr, xg, yg, xb, yb), all D65-referred unless noted ------
PRIMARIES = {
    "srgb": (0.640, 0.330, 0.300, 0.600, 0.150, 0.060),
    "rec2020": (0.708, 0.292, 0.170, 0.797, 0.131, 0.046),
    "adobergb": (0.640, 0.330, 0.210, 0.710, 0.150, 0.060),
    "displayp3": (0.680, 0.320, 0.265, 0.690, 0.150, 0.060),
    "prophoto": (0.7347, 0.2653, 0.1596, 0.8404, 0.0366, 0.0001),  # D50 native
}
PROFILE_WHITE = {k: WP_D65 for k in PRIMARIES}
PROFILE_WHITE["prophoto"] = WP_D50


def xy_to_XYZ(x: float, y: float, Y: float = 1.0) -> np.ndarray:
    return np.array([x * Y / y, Y, (1.0 - x - y) * Y / y], dtype=np.float64)


def rgb_to_xyz_matrix(primaries, white_xy) -> np.ndarray:
    """3x3 linear-RGB -> XYZ from chromaticities (standard derivation:
    scale primary columns so they sum to the white point)."""
    xr, yr, xg, yg, xb, yb = primaries
    P = np.array(
        [
            [xr / yr, xg / yg, xb / yb],
            [1.0, 1.0, 1.0],
            [(1 - xr - yr) / yr, (1 - xg - yg) / yg, (1 - xb - yb) / yb],
        ],
        dtype=np.float64,
    )
    W = xy_to_XYZ(*white_xy)
    S = np.linalg.solve(P, W)
    return P * S[None, :]


# Bradford cone response matrix (standard CAT used by ICC / the reference's
# chromatic_adaptation.h)
BRADFORD = np.array(
    [
        [0.8951, 0.2664, -0.1614],
        [-0.7502, 1.7135, 0.0367],
        [0.0389, -0.0685, 1.0296],
    ],
    dtype=np.float64,
)
# CAT16 cone response matrix (CIECAM16), used by channelmixerrgb's CAT16 mode
CAT16 = np.array(
    [
        [0.401288, 0.650173, -0.051461],
        [-0.250268, 1.204414, 0.045854],
        [-0.002079, 0.048952, 0.953127],
    ],
    dtype=np.float64,
)


def adaptation_matrix(src_white_XYZ, dst_white_XYZ, cone: np.ndarray = BRADFORD) -> np.ndarray:
    """Von-Kries style chromatic adaptation XYZ_src -> XYZ_dst."""
    src = cone @ np.asarray(src_white_XYZ, dtype=np.float64)
    dst = cone @ np.asarray(dst_white_XYZ, dtype=np.float64)
    return np.linalg.inv(cone) @ np.diag(dst / src) @ cone


def profile_matrix(name: str, to_xyz: bool = True, dst_white_xy=WP_D65) -> np.ndarray:
    """RGB<->XYZ matrix for a named profile, chromatically adapted to
    ``dst_white_xy`` (pipeline XYZ reference is D65)."""
    M = rgb_to_xyz_matrix(PRIMARIES[name], PROFILE_WHITE[name])
    native = PROFILE_WHITE[name]
    if native != dst_white_xy:
        M = adaptation_matrix(xy_to_XYZ(*native), xy_to_XYZ(*dst_white_xy)) @ M
    return M if to_xyz else np.linalg.inv(M)


def rgb_to_rgb_matrix(src: str, dst: str) -> np.ndarray:
    return profile_matrix(dst, to_xyz=False) @ profile_matrix(src, to_xyz=True)


# The pipeline working space (reference default: linear Rec2020,
# src/develop/imageop.h work profile plumbing / iop_profile.c).
#
# Pipeline PCS white is D50, matching the reference exactly: its work
# profiles are LCMS ICC profiles whose matrices are D50-adapted (PCS),
# Lab is D50-based (colorspaces_inline_conversions.h dt_XYZ_to_Lab),
# and channelmixerrgb's CATs target hard D50 products
# (pixel/chromatic_adaptation.h bradford_adapt_D50 et al).
PIPE_WHITE_XY = WP_D50
PIPE_WHITE_XYZ = xy_to_XYZ(*WP_D50)
WORK_PROFILE = "rec2020"
XYZ_FROM_WORK = profile_matrix(WORK_PROFILE, to_xyz=True,
                               dst_white_xy=PIPE_WHITE_XY)
WORK_FROM_XYZ = profile_matrix(WORK_PROFILE, to_xyz=False,
                               dst_white_xy=PIPE_WHITE_XY)

# Y row of the working profile: luminance weights for work-RGB
WORK_Y = XYZ_FROM_WORK[1, :].copy()

# Pre-solved D50 <-> D65 XYZ adaptations (CAT16), the analog of the
# reference's XYZ_D50_to_D65 tables (chromatic_adaptation.h:248-268) —
# used at the boundary of D65-defined spaces (JzAzBz, LMS2006/Yrg)
XYZ_D50_TO_D65 = adaptation_matrix(xy_to_XYZ(*WP_D50), xy_to_XYZ(*WP_D65),
                                   cone=CAT16)
XYZ_D65_TO_D50 = np.linalg.inv(XYZ_D50_TO_D65)


def cam_to_work_matrix(cam_to_xyz: np.ndarray) -> np.ndarray:
    """camera RGB -> working RGB (colorin's job for camera-matrix profiles,
    reference src/iop/colorin.c commit path)."""
    return WORK_FROM_XYZ @ np.asarray(cam_to_xyz, dtype=np.float64).reshape(3, 3)


def normalized_cam_to_work(cam_to_xyz: np.ndarray) -> np.ndarray:
    """Normalize rows so that camera white (1,1,1) maps to work white (1,1,1)
    — mirrors the reference's white-point normalization of camera matrices
    (src/common/colorspaces.c camera matrix path)."""
    M = cam_to_work_matrix(cam_to_xyz)
    white = M @ np.ones(3)
    return M / white[:, None]
