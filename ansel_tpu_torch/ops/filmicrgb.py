"""filmicrgb — scene->display parametric tone mapping.

Reference: `ansel/src/iop/filmicrgb.c` (params v5 filmicrgb.c:229-259).
The host half (spline solve `dt_iop_filmic_rgb_compute_spline`
filmicrgb.c:3614-3932, commit-time coefficients) is copied from
`ansel_tpu/ops/filmicrgb.py`.  The per-pixel half, in torch here and as
a stage of the chain kernel: the AgX route (filmic_agx,
filmicrgb.c:2436-2520: `_agx_pixel`, the FILMIC_AGX opcode) and the
spline route of colour sciences v1-v5 (`_tonemap_pixel`: the v2/v3
split and chroma loops filmicrgb.c:1551-1705 with desaturate_v1/v2, the
v4/v5 norm and per-channel tone maps with the Ych gamut mapping
filmicrgb.c:2085-2283; the FILMIC_SPLINE opcode), both with the log tone
map filmicrgb.c:1025-1029 and the spline eval filmicrgb.c:1042-1140.
The highlight reconstruction before them (filmicrgb.c:1408-1509,
2680-2780: noise inpainting and a-trous wavelet passes on the sepblur
kernel) is followed by the tone map as a one-stage chain.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.params import cfield, params
from ..core.types import Colorspace, ImageSpec
from ..kernels import pointwise
from ..kernels.pointwise import OP_FILMIC_AGX, OP_FILMIC_SPLINE
from ..pixel import prng
from ..pixel.wavelets import bspline_blur
from .base import (Op, OpPlan, PlanContext, PointwiseSpec, channel_mean,
                   register)

NORM_MIN = 1.52587890625e-05  # 2^-16 (reference src/math/math.h:37)
SAFETY_MARGIN = 0.01          # reference filmicrgb.c spline geometry

# methods (filmicrgb.c:131-139)
METHOD_NONE = 0
METHOD_MAX_RGB = 1
METHOD_LUMINANCE = 2
METHOD_POWER_NORM = 3
METHOD_EUCLIDEAN_V1 = 4
METHOD_EUCLIDEAN_V2 = 5

# curve types (filmicrgb.c:142-152)
CURVE_POLY_4 = 0
CURVE_POLY_3 = 1
CURVE_RATIONAL = 2
CURVE_SIGMOID = 3

# colorscience (filmicrgb.c:155-167)
CSCI_V1, CSCI_V2, CSCI_V3, CSCI_V4, CSCI_V5 = 0, 1, 2, 3, 4
CSCI_AGX_FIRST = 5  # V6..V10 are AgX bleach variants

SPLINE_V1, SPLINE_V2, SPLINE_V3 = 0, 1, 2

# camera-rgb fallback luminance weights
# (colorspaces_inline_conversions.h:618-621); the work-profile Y row is used
# when available, matching dt_ioppr_get_rgb_matrix_luminance
_FALLBACK_Y = (0.2225045, 0.7168786, 0.0606169)


@params(op="filmicrgb", version=5)
@dataclasses.dataclass
class FilmicParams:
    grey_point_source: float = cfield("f", 18.45)
    black_point_source: float = cfield("f", -8.0)
    white_point_source: float = cfield("f", 4.0)
    reconstruct_threshold: float = cfield("f", 3.0)
    reconstruct_feather: float = cfield("f", 3.0)
    reconstruct_bloom_vs_details: float = cfield("f", 100.0)
    reconstruct_grey_vs_color: float = cfield("f", 100.0)
    reconstruct_structure_vs_texture: float = cfield("f", 100.0)
    security_factor: float = cfield("f", 0.0)
    grey_point_target: float = cfield("f", 18.45)
    black_point_target: float = cfield("f", 0.01517634)
    white_point_target: float = cfield("f", 100.0)
    output_power: float = cfield("f", 4.0)
    latitude: float = cfield("f", 10.0)
    contrast: float = cfield("f", 1.18)
    saturation: float = cfield("f", 0.0)
    balance: float = cfield("f", 0.0)
    noise_level: float = cfield("f", 0.05)
    preserve_color: int = cfield("i", METHOD_MAX_RGB)
    version: int = cfield("i", 7)          # DT_FILMIC_COLORSCIENCE_V8
    auto_hardness: int = cfield("i", 1)
    custom_grey: int = cfield("i", 0)
    high_quality_reconstruction: int = cfield("i", 1)
    noise_distribution: int = cfield("i", 1)
    shadows: int = cfield("i", CURVE_SIGMOID)
    highlights: int = cfield("i", CURVE_SIGMOID)
    compensate_icc_black: int = cfield("i", 0)
    spline_version: int = cfield("i", SPLINE_V3)

    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        if version == 4:
            # filmicrgb.c legacy v4->v5: identical 112B layout, the last
            # field was a year (2019/2020/2021) instead of the spline enum
            p = cls.codec.decode(raw)
            p.spline_version = {2019: SPLINE_V1, 2020: SPLINE_V2,
                                2021: SPLINE_V3}.get(p.spline_version,
                                                     SPLINE_V3)
            return p
        if version == 3:
            # v3 = v5 prefix minus {compensate_icc_black, spline_version}
            p = cls.codec.decode(raw[:104] + b"\0" * 8)
            p.compensate_icc_black = 0
            p.spline_version = SPLINE_V1
            return p
        if version == 2:
            # filmicrgb.c legacy v2 branch: no noise fields, shadows/
            # highlights curve types at the tail
            v = struct.unpack("<17fiiiiiii", raw[:96])
            return cls(
                grey_point_source=v[0], black_point_source=v[1],
                white_point_source=v[2], reconstruct_threshold=v[3],
                reconstruct_feather=v[4], reconstruct_bloom_vs_details=v[5],
                reconstruct_grey_vs_color=v[6],
                reconstruct_structure_vs_texture=v[7], security_factor=v[8],
                grey_point_target=v[9], black_point_target=v[10],
                white_point_target=v[11], output_power=v[12], latitude=v[13],
                contrast=v[14], saturation=v[15], balance=v[16],
                preserve_color=v[17], version=v[18], auto_hardness=v[19],
                custom_grey=v[20], high_quality_reconstruction=v[21],
                shadows=v[22], highlights=v[23], noise_level=0.0,
                compensate_icc_black=0, spline_version=SPLINE_V1)
        if version == 1:
            # filmicrgb.c legacy v1 branch
            v = struct.unpack("<12fi", raw[:52])
            return cls(
                grey_point_source=v[0], black_point_source=v[1],
                white_point_source=v[2], security_factor=v[3],
                grey_point_target=v[4], black_point_target=v[5],
                white_point_target=v[6], output_power=v[7], latitude=v[8],
                contrast=v[9], saturation=v[10], balance=v[11],
                preserve_color=v[12], shadows=CURVE_POLY_4,
                highlights=CURVE_POLY_3, reconstruct_threshold=6.0,
                reconstruct_feather=3.0, version=CSCI_V1, auto_hardness=1,
                custom_grey=1, high_quality_reconstruction=0,
                noise_level=0.0, compensate_icc_black=0,
                spline_version=SPLINE_V1)
        return None


@dataclasses.dataclass
class Spline:
    x: list
    y: list
    M1: list
    M2: list
    M3: list
    M4: list
    M5: list
    latitude_min: float = 0.0
    latitude_max: float = 1.0
    types: tuple = (CURVE_SIGMOID, CURVE_SIGMOID)


def _clamp(v, lo, hi):
    return min(max(v, lo), hi)


def _sigmoid_scale(limit_x, limit_y, tx, ty, slope, power):
    """filmicrgb.c:3602-3610."""
    projected = slope * max(1e-6, limit_x - tx)
    actual = max(1e-6, limit_y - ty)
    base = max(1e-6, actual ** (-power) - projected ** (-power))
    return min(1e9, base ** (-1.0 / power))


def _v3_geometry(p: FilmicParams):
    """filmic_v3_compute_geometry (filmicrgb.c:476-513)."""
    if p.custom_grey:
        grey_display = (
            _clamp(p.grey_point_target, p.black_point_target, p.white_point_target)
            / 100.0
        ) ** (1.0 / p.output_power)
    else:
        grey_display = 0.1845 ** (1.0 / p.output_power)
    dr = p.white_point_source - p.black_point_source
    grey_log = abs(p.black_point_source) / dr
    black_display = (_clamp(p.black_point_target, 0.0, p.grey_point_target) / 100.0) ** (
        1.0 / p.output_power
    )
    white_display = (max(p.white_point_target, p.grey_point_target) / 100.0) ** (
        1.0 / p.output_power
    )
    slope = p.contrast * dr / 8.0
    min_contrast = 1.0
    min_contrast = max(min_contrast, (white_display - grey_display) / (1.0 - grey_log))
    min_contrast = max(min_contrast, (grey_display - black_display) / grey_log)
    min_contrast += SAFETY_MARGIN
    contrast = slope / (p.output_power * grey_display ** (p.output_power - 1.0))
    contrast = _clamp(contrast, min_contrast, 100.0)
    intercept = grey_display - contrast * grey_log
    margin = SAFETY_MARGIN * (white_display - black_display)
    xmin = (black_display + margin - intercept) / contrast
    xmax = (white_display - margin - intercept) / contrast
    return dict(
        grey_log=grey_log, grey_display=grey_display, black_display=black_display,
        white_display=white_display, contrast=contrast, intercept=intercept,
        xmin=xmin, xmax=xmax,
    )


def compute_spline(p: FilmicParams) -> Spline:
    """Host mirror of dt_iop_filmic_rgb_compute_spline (filmicrgb.c:3614+)."""
    dr = p.white_point_source - p.black_point_source
    grey_log = abs(p.black_point_source) / dr
    black_log, white_log = 0.0, 1.0

    if p.custom_grey:
        grey_display = (
            _clamp(p.grey_point_target, p.black_point_target, p.white_point_target)
            / 100.0
        ) ** (1.0 / p.output_power)
    else:
        grey_display = 0.1845 ** (1.0 / p.output_power)

    if p.spline_version == SPLINE_V1:
        black_display = _clamp(p.black_point_target, 0.0, p.grey_point_target) / 100.0
        white_display = max(p.white_point_target, p.grey_point_target) / 100.0
    else:
        black_display = (
            _clamp(p.black_point_target, 0.0, p.grey_point_target) / 100.0
        ) ** (1.0 / p.output_power)
        white_display = (
            max(p.white_point_target, p.grey_point_target) / 100.0
        ) ** (1.0 / p.output_power)

    balance = _clamp(p.balance, -50.0, 50.0) / 100.0
    if p.spline_version < SPLINE_V3:
        latitude = _clamp(p.latitude, 0.0, 100.0) / 100.0 * dr
        contrast = _clamp(p.contrast, 1.00001, 6.0)
        # legacy commit-side contrast floor (commit_params filmicrgb.c)
        if contrast < grey_display / grey_log:
            contrast = 1.0001 * grey_display / grey_log
        toe_log = grey_log - latitude / dr * abs(p.black_point_source / dr)
        shoulder_log = grey_log + latitude / dr * abs(p.white_point_source / dr)
        intercept = grey_display - contrast * grey_log
        toe_display = toe_log * contrast + intercept
        shoulder_display = shoulder_log * contrast + intercept
        norm = math.sqrt(contrast * contrast + 1.0)
        coeff = -((2.0 * latitude) / dr) * balance
        toe_display += coeff * contrast / norm
        shoulder_display += coeff * contrast / norm
        toe_log += coeff / norm
        shoulder_log += coeff / norm
    else:
        g = _v3_geometry(p)
        contrast = g["contrast"]
        latitude = _clamp(p.latitude, 0.0, 100.0) / 100.0
        toe_log = (1.0 - latitude) * g["grey_log"] + latitude * g["xmin"]
        shoulder_log = (1.0 - latitude) * g["grey_log"] + latitude * g["xmax"]
        corr = (
            2.0 * balance * (shoulder_log - g["grey_log"])
            if balance > 0.0
            else 2.0 * balance * (g["grey_log"] - toe_log)
        )
        toe_log = max(toe_log - corr, g["xmin"])
        shoulder_log = min(shoulder_log - corr, g["xmax"])
        toe_display = toe_log * contrast + g["intercept"]
        shoulder_display = shoulder_log * contrast + g["intercept"]

    x = [black_log, toe_log, grey_log, shoulder_log, white_log]
    y = [black_display, toe_display, grey_display, shoulder_display, white_display]

    M1 = [0.0] * 3
    M2 = [0.0] * 3
    M3 = [0.0] * 3
    M4 = [0.0] * 3
    M5 = [0.0] * 3

    # linear latitude segment
    M2[2] = contrast
    M1[2] = y[1] - M2[2] * x[1]

    sigmoid_toe_power = 1.5
    slope = M2[2]
    if p.shadows == CURVE_SIGMOID or p.highlights == CURVE_SIGMOID:
        M3[2] = y[0]  # target black
        M4[2] = y[4]  # target white

    Tl, Sl = x[1], x[3]

    # --- toe -----------------------------------------------------------------
    if p.shadows == CURVE_SIGMOID:
        tx, ty, y0 = x[1], y[1], y[0]
        dx = max(1e-6, tx)
        dy = max(1e-6, ty - y0)
        M1[0] = -_sigmoid_scale(1.0, 1.0 - y0, 1.0 - tx, 1.0 - ty, slope,
                                sigmoid_toe_power)
        M2[0] = sigmoid_toe_power
        M4[0] = slope * dx / dy
        M3[0] = dy / dx ** M4[0]
        M5[0] = 1.0 if dy / dx > slope else 0.0
    elif p.shadows == CURVE_POLY_4:
        A = np.array(
            [
                [0, 0, 0, 0, 1],
                [0, 0, 0, 1, 0],
                [Tl**4, Tl**3, Tl**2, Tl, 1],
                [4 * Tl**3, 3 * Tl**2, 2 * Tl, 1, 0],
                [12 * Tl**2, 6 * Tl, 2, 0, 0],
            ],
            dtype=np.float64,
        )
        b = np.array([y[0], 0.0, y[1], M2[2], 0.0])
        s = np.linalg.solve(A, b)
        M5[0], M4[0], M3[0], M2[0], M1[0] = s
    elif p.shadows == CURVE_POLY_3:
        A = np.array(
            [
                [0, 0, 0, 1],
                [Tl**3, Tl**2, Tl, 1],
                [3 * Tl**2, 2 * Tl, 1, 0],
                [6 * Tl, 2, 0, 0],
            ],
            dtype=np.float64,
        )
        b = np.array([y[0], y[1], M2[2], 0.0])
        s = np.linalg.solve(A, b)
        M5[0] = 0.0
        M4[0], M3[0], M2[0], M1[0] = s
    else:  # rational
        xx = x[1] - x[0]
        yy = y[1] - y[0]
        g_ = contrast
        b_ = g_ / (2.0 * yy) + (math.sqrt((xx * g_ / yy + 1.0) ** 2 - 4.0) - 1.0) / (
            2.0 * xx
        )
        c_ = yy / g_ * (b_ * xx**2 + xx) / (b_ * xx**2 + xx - (yy / g_))
        M1[0] = c_ * g_
        M2[0] = b_
        M3[0] = c_
        M4[0] = y[1]

    # --- shoulder ------------------------------------------------------------
    if p.highlights == CURVE_SIGMOID:
        sx, sy, y4 = x[3], y[3], y[4]
        dx = max(1e-6, 1.0 - sx)
        dy = max(1e-6, y4 - sy)
        M4[1] = slope * dx / dy
        M3[1] = dy / dx ** M4[1]
        M5[1] = 1.0
        # generalized-sigmoid scale for the non-degenerate branch
        M1[1] = _sigmoid_scale(1.0, y4, sx, sy, slope, M4[1])
        M2[1] = M4[1]
    elif p.highlights == CURVE_POLY_3:
        A = np.array(
            [
                [1, 1, 1, 1],
                [Sl**3, Sl**2, Sl, 1],
                [3 * Sl**2, 2 * Sl, 1, 0],
                [6 * Sl, 2, 0, 0],
            ],
            dtype=np.float64,
        )
        b = np.array([y[4], y[3], M2[2], 0.0])
        s = np.linalg.solve(A, b)
        M5[1] = 0.0
        M4[1], M3[1], M2[1], M1[1] = s
    elif p.highlights == CURVE_POLY_4:
        A = np.array(
            [
                [1, 1, 1, 1, 1],
                [4, 3, 2, 1, 0],
                [Sl**4, Sl**3, Sl**2, Sl, 1],
                [4 * Sl**3, 3 * Sl**2, 2 * Sl, 1, 0],
                [12 * Sl**2, 6 * Sl, 2, 0, 0],
            ],
            dtype=np.float64,
        )
        b = np.array([y[4], 0.0, y[3], M2[2], 0.0])
        s = np.linalg.solve(A, b)
        M5[1], M4[1], M3[1], M2[1], M1[1] = s
    else:  # rational
        xx = x[4] - x[3]
        yy = y[4] - y[3]
        g_ = contrast
        b_ = g_ / (2.0 * yy) + (math.sqrt((xx * g_ / yy + 1.0) ** 2 - 4.0) - 1.0) / (
            2.0 * xx
        )
        c_ = yy / g_ * (b_ * xx**2 + xx) / (b_ * xx**2 + xx - (yy / g_))
        M1[1] = c_ * g_
        M2[1] = b_
        M3[1] = c_
        M4[1] = y[3]

    return Spline(x=x, y=y, M1=M1, M2=M2, M3=M3, M4=M4, M5=M5,
                  latitude_min=x[1], latitude_max=x[3],
                  types=(p.shadows, p.highlights))


# --- device side -------------------------------------------------------------


def _log_tonemapping(x, grey, black, dynamic_range):
    """log_tonemapping (filmicrgb.c:1025-1029), made total as in the JAX
    version: the input is clamped to NORM_MIN first."""
    xx = torch.clamp(x, min=NORM_MIN)
    return torch.clamp((torch.log2(xx / grey) - black) / dynamic_range,
                       0.0, 1.0)


def _spline_eval(x, types, c):
    """filmic_spline (filmicrgb.c:1042-1140).  Curve types are static;
    coefficients come from the coefficient dict `c`."""
    lat_min = c["lat_min"]
    lat_max = c["lat_max"]
    M1, M2, M3, M4, M5 = c["M1"], c["M2"], c["M3"], c["M4"], c["M5"]

    # toe
    t_type = types[0]
    if t_type == CURVE_SIGMOID:
        ty = lat_min * M2[2] + M1[2]
        u = M2[2] * (x - lat_min) / M1[0]
        sig = M1[0] * (u / (1.0 + u ** M2[0]) ** (1.0 / M2[0])) + ty
        powc = M3[2] + torch.clamp(
            M3[0] * torch.clamp(x, min=0.0) ** M4[0], min=0.0)
        toe = torch.where(M5[0] != 0.0, powc, sig)
    elif t_type == CURVE_POLY_4:
        toe = M1[0] + x * (M2[0] + x * (M3[0] + x * (M4[0] + x * M5[0])))
    elif t_type == CURVE_POLY_3:
        toe = M1[0] + x * (M2[0] + x * (M3[0] + x * M4[0]))
    else:
        xi = lat_min - x
        rat = xi * (xi * M2[0] + 1.0)
        toe = M4[0] - M1[0] * rat / (rat + M3[0])

    # shoulder
    s_type = types[1]
    if s_type == CURVE_SIGMOID:
        ty = lat_max * M2[2] + M1[2]
        u = M2[2] * (x - lat_max) / M1[1]
        sig = M1[1] * (u / (1.0 + u ** M2[1]) ** (1.0 / M2[1])) + ty
        powc = M4[2] - torch.clamp(
            M3[1] * torch.clamp(1.0 - x, min=0.0) ** M4[1], min=0.0)
        shoulder = torch.where(M5[1] != 0.0, powc, sig)
    elif s_type == CURVE_POLY_4:
        shoulder = M1[1] + x * (M2[1] + x * (M3[1] + x * (M4[1] + x * M5[1])))
    elif s_type == CURVE_POLY_3:
        shoulder = M1[1] + x * (M2[1] + x * (M3[1] + x * M4[1]))
    else:
        xi = x - lat_max
        rat = xi * (xi * M2[1] + 1.0)
        shoulder = M4[1] + M1[1] * rat / (rat + M3[1])

    lat = M1[2] + x * M2[2]
    return torch.where(x < lat_min, toe,
                       torch.where(x > lat_max, shoulder, lat))


def _desaturate_v2(x, sigma_toe, sigma_shoulder, saturation):
    r_toe = x
    r_shoulder = 1.0 - x
    sat2 = 0.5 / torch.sqrt(saturation)
    key_toe = torch.exp(-r_toe * r_toe / sigma_toe * sat2)
    key_shoulder = torch.exp(-r_shoulder * r_shoulder / sigma_shoulder * sat2)
    return saturation - (key_toe + key_shoulder) * saturation


def _desaturate_v1(x, sigma_toe, sigma_shoulder, saturation):
    key_toe = torch.exp(-0.5 * x * x / sigma_toe)
    one_x = 1.0 - x
    key_shoulder = torch.exp(-0.5 * (one_x * one_x) / sigma_shoulder)
    return 1.0 - torch.clamp((key_toe + key_shoulder) / saturation, 0.0, 1.0)


_SQRT3 = math.sqrt(3.0)


def _pixel_norm(rgb, variant: int, w):
    """(3, H, W) -> (H, W); get_pixel_norm (filmicrgb.c:955-1014).  The
    sums over the channels run (r + g) + b, as XLA reduces three values
    and the chain kernel adds them."""
    if variant == METHOD_MAX_RGB:
        return torch.amax(rgb, dim=0)
    if variant == METHOD_LUMINANCE or variant == METHOD_NONE:
        return w[0] * rgb[0] + w[1] * rgb[1] + w[2] * rgb[2]
    if variant == METHOD_POWER_NORM:
        a = torch.abs(rgb)
        sq = a * a
        cube = sq * a
        return (cube[0] + cube[1] + cube[2]) \
            / torch.clamp(sq[0] + sq[1] + sq[2], min=1e-12)
    sq = rgb * rgb
    norm = torch.sqrt(sq[0] + sq[1] + sq[2])
    if variant == METHOD_EUCLIDEAN_V1:
        return norm
    # METHOD_EUCLIDEAN_V2: a 0-d divisor, so that torch on CUDA divides
    # as the kernel does (by a Python float it multiplies by the
    # reciprocal)
    return norm / torch.full((), _SQRT3, device=rgb.device)


@register
class FilmicRGB(Op):
    name = "filmicrgb"
    input_colorspace = Colorspace.WORK_RGB

    def enabled_by_default(self, meta):
        return False

    def plan(self, ctx: PlanContext, spec_in: ImageSpec, p: FilmicParams) -> OpPlan:
        version = p.version
        preserve = p.preserve_color
        if version >= CSCI_AGX_FIRST:
            # AgX ignores preserve_color (dispatch filmicrgb.c:2785-2790)
            version_class = CSCI_AGX_FIRST
            preserve = METHOD_MAX_RGB
        else:
            version_class = min(version, CSCI_V5)
        # highlight reconstruction (filmicrgb.c:2680-2780): armed only
        # when the scene can actually clip past the threshold — the
        # running processed_maximum bounds the euclidean norm, so when
        # sqrt(3)*max < (feather-4)/feather * threshold no pixel can
        # satisfy mask_clipped_pixels' `argument < 4` census
        # (filmicrgb.c:1196-1203) and the reference path is a no-op.
        # PREVIEW/THUMBNAIL pipes skip it like the reference's fast mode.
        rec = None
        grey_source = p.grey_point_source / 100.0 if p.custom_grey else 0.1845
        threshold = 2.0 ** (p.white_point_source
                            + p.reconstruct_threshold) * grey_source
        feather = 2.0 ** (12.0 / max(p.reconstruct_feather, 1e-3))
        pm_bound = math.sqrt(3.0) * max(max(ctx.processed_maximum), 1e-6)
        can_clip = pm_bound > max((feather - 4.0) / feather, 1e-6) * threshold
        from ..core import conf as _conf

        fast_pipe = ctx.notes.get("pipe_type") in ("preview", "thumbnail")
        if (can_clip or _conf.get_bool("filmic.force_reconstruct")) \
                and not fast_pipe:
            dim = max(spec_in.width, spec_in.height)
            scales = int(np.clip(math.floor(
                math.log2(max(2.0 * dim / 20.0 - 1.0, 2.0))), 1, 10))
            rec = (scales, max(int(p.high_quality_reconstruction), 0))
        static = (version_class, preserve, p.shadows, p.highlights,
                  p.version, rec)
        return OpPlan(spec_in=spec_in, spec_out=spec_in, static=static)

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: FilmicParams):
        s = compute_spline(p)
        grey_source = p.grey_point_source / 100.0 if p.custom_grey else 0.1845
        if p.version >= CSCI_V4:
            saturation = p.saturation / 100.0
        else:
            saturation = 2.0 * p.saturation / 100.0 + 1.0
        sigma_toe = (s.latitude_min / 3.0) ** 2
        sigma_shoulder = ((1.0 - s.latitude_max) / 3.0) ** 2
        from ..color import matrices as cm

        return {
            "M1": np.float32(s.M1), "M2": np.float32(s.M2),
            "M3": np.float32(s.M3), "M4": np.float32(s.M4),
            "M5": np.float32(s.M5),
            "lat_min": np.float32(s.latitude_min),
            "lat_max": np.float32(s.latitude_max),
            "y0": np.float32(s.y[0]), "y4": np.float32(s.y[4]),
            "grey_source": np.float32(grey_source),
            "black_source": np.float32(p.black_point_source),
            "dynamic_range": np.float32(
                p.white_point_source - p.black_point_source
            ),
            "output_power": np.float32(p.output_power),
            # v1/v2 divide by sqrt(saturation) -> clamp there only; the
            # v4+ slider is bipolar (desaturate_v4 needs the sign)
            "saturation": np.float32(
                saturation if p.version >= CSCI_V4
                else max(saturation, 1e-6)),
            "sigma_toe": np.float32(max(sigma_toe, 1e-9)),
            "sigma_shoulder": np.float32(max(sigma_shoulder, 1e-9)),
            "y_weights": np.float32(cm.WORK_Y),
            # v4 norm clamp bounds: exp_tonemapping of log range ends
            # (filmicrgb.c:2151-2152)
            "norm_min": np.float32(
                grey_source * 2.0 ** p.black_point_source
            ),
            "norm_max": np.float32(
                grey_source * 2.0 ** p.white_point_source
            ),
            "display_black": np.float32(s.y[0] ** p.output_power),
            "display_white": np.float32(s.y[4] ** p.output_power),
            # AgX hue recovery mix (commit_params filmicrgb.c:4020-4024)
            "beta_hue": np.float32(
                0.5 * (min(max(p.saturation / 100.0, -1.0), 1.0) + 1.0)
            ),
            # highlight reconstruction (commit_params filmicrgb.c:4028-4036)
            "rec_threshold": np.float32(
                2.0 ** (p.white_point_source + p.reconstruct_threshold)
                * grey_source),
            "rec_feather": np.float32(
                2.0 ** (12.0 / max(p.reconstruct_feather, 1e-3))),
            "rec_gamma": np.float32(
                (p.reconstruct_structure_vs_texture / 100.0 + 1.0) / 2.0),
            "rec_delta": np.float32(
                (p.reconstruct_bloom_vs_details / 100.0 + 1.0) / 2.0),
            "rec_beta": np.float32(
                (p.reconstruct_grey_vs_color / 100.0 + 1.0) / 2.0),
            "noise_level": np.float32(
                p.noise_level / max(ctx.scale, 1.0)),
        }

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        """Highlight reconstruction when planned, then the tone map (AgX
        or the spline route) through the chain kernel as a program of its
        own (the JAX package fuses it, or runs `_apply_agx` through
        `pallas_pointwise`)."""
        rec = plan.static[5]
        if rec is not None:
            x = self._reconstruct_highlights(x, c, rec)
        return pointwise.pointwise_chain(x.contiguous(),
                                         self._tonemap_chain(x, c, plan))

    def _tonemap_chain(self, x, c, plan):
        """The one-stage tone-map chain for these device coefficients,
        packed once (packing reads the coefficients back to the host)."""
        hit = _TONEMAP_CHAINS.get(id(c))
        if hit is None or hit[0] is not c \
                or hit[1].prog.device != x.device:
            chain = pointwise.pack_chain([self._spec(plan)], [c], x.device)
            _TONEMAP_CHAINS[id(c)] = hit = (c, chain)
            while len(_TONEMAP_CHAINS) > 8:
                del _TONEMAP_CHAINS[next(iter(_TONEMAP_CHAINS))]
        return hit[1]

    # consts the chain kernel reads, in order (25 floats)
    _AGX_CONSTS = ("M1", "M2", "M3", "M4", "M5", "lat_min", "lat_max",
                   "grey_source", "black_source", "dynamic_range",
                   "output_power", "y4", "display_black", "display_white",
                   "beta_hue")

    def pointwise_spec(self, plan, ctx):
        """The chain stage, except when highlight reconstruction is
        planned (a spatial wavelet pass): then the stage runs alone."""
        if plan.static[5] is not None:
            return None
        return self._spec(plan)

    def _spec(self, plan):
        if plan.static[0] == CSCI_AGX_FIRST:
            return self._agx_spec(plan)
        return self._spline_spec(plan)

    def _agx_spec(self, plan):
        from . import filmic_agx as agx
        from ..color import matrices as cm

        mats = self._agx_matrices(plan.static[4])
        folds = []
        for row in mats[3]:
            folds.extend(agx.gamut_fold([float(v) for v in row]))
        extra = [float(v) for m in mats for row in m for v in row]
        extra += [float(v) for v in cm.WORK_Y] + folds
        return PointwiseSpec(
            fn=lambda x, c: self._agx(x, c, plan.static),
            opcode=OP_FILMIC_AGX, consts=self._AGX_CONSTS,
            ints=tuple(plan.static[2:4]), extra=tuple(extra))

    # consts of the spline route, in the JAX package's order (33 floats;
    # every colour science v1-v5 reads a subset)
    _SPLINE_CONSTS = ("M1", "M2", "M3", "M4", "M5", "lat_min", "lat_max",
                      "y0", "y4", "output_power", "grey_source",
                      "black_source", "dynamic_range", "y_weights",
                      "sigma_toe", "sigma_shoulder", "saturation",
                      "norm_min", "norm_max", "display_black",
                      "display_white")

    def _spline_spec(self, plan):
        """Colour sciences v1-v5: the kernel's ints are the curve types,
        the colour science and the preserve method; after the consts come
        the Ych matrices and the gamut folds v4 and v5 read."""
        from . import filmic_agx as agx

        input_m, output_m = (m.tolist() for m in agx.agx_matrices())
        extra = [float(v) for m in (input_m, output_m) for row in m
                 for v in row]
        for row in output_m:
            extra.extend(agx.gamut_fold([float(v) for v in row]))
        return PointwiseSpec(
            fn=lambda x, c: self._tonemap_pixel(x, c, plan.static),
            opcode=OP_FILMIC_SPLINE, consts=self._SPLINE_CONSTS,
            ints=tuple(plan.static[2:4]) + tuple(plan.static[0:2]),
            extra=tuple(extra))

    def _tonemap_pixel(self, x, c, static):
        """Per-pixel tone mapping of colour sciences v1-v5 (the JAX
        package's `_tonemap_pixel`, in its operand order)."""
        from . import filmic_agx as agx

        version, preserve = static[0], static[1]
        types = static[2:4]
        gs, bs, dr = c["grey_source"], c["black_source"], c["dynamic_range"]

        def curve(v):
            mapped = _spline_eval(v, types, c)
            return torch.clamp(mapped, c["y0"], c["y4"]) ** c["output_power"]

        if version >= CSCI_V4:
            # tone map, then the Ych gamut mapping (filmic_chroma_v4,
            # filmic_split_v4 :2131-2224, filmic_v5 :2227-2283,
            # gamut_mapping_simd :1965-2010)
            input_m, output_m = (m.tolist() for m in agx.agx_matrices())

            def rgb_tone_map(v):
                # RGB_tone_mapping_v4 (filmicrgb.c:2113-2128)
                sp_ = _spline_eval(_log_tonemapping(v, gs, bs, dr), types, c)
                return torch.clamp(sp_, torch.zeros_like(c["y4"]),
                                   c["y4"]) ** c["output_power"]

            def norm_tone_map(v, method):
                # norm_tone_mapping_v4 (filmicrgb.c:2085-2110): the norm
                # clamped first, so clipped highlights keep a sane chroma
                norm = torch.clamp(_pixel_norm(v, method, c["y_weights"]),
                                   c["norm_min"], c["norm_max"])
                nout = curve(_log_tonemapping(norm, gs, bs, dr))
                return (v / norm[None]) * nout[None]

            if version == CSCI_V4:
                split = preserve == METHOD_NONE
                out = rgb_tone_map(x) if split \
                    else norm_tone_map(x, preserve)
                sat = c["saturation"]
            else:  # CSCI_V5: the max-RGB norm blended with the channels
                naive = rgb_tone_map(x)
                mx = norm_tone_map(x, METHOD_MAX_RGB)
                out = (0.5 + c["saturation"]) * mx \
                    + (0.5 - c["saturation"]) * naive
                split = True
                sat = 0.0
            Y0, c0, cos0, sin0 = agx.rgb_to_ych(x, input_m)
            Yf, cf, _, _ = agx.rgb_to_ych(out, input_m)
            if split:
                cf = torch.minimum(c0, cf)
            Yf = torch.clamp(Yf, agx.CIE_Y_2006 * c["display_black"],
                             agx.CIE_Y_2006 * c["display_white"])
            cf = agx.desaturate_v4(Y0, c0, Yf, cf, sat)
            return agx.gamut_map(Yf, cf, cos0, sin0, input_m, output_m,
                                 c["display_black"], c["display_white"])

        w = c["y_weights"]
        if preserve == METHOD_NONE:
            # filmic_split_v2_v3 (filmicrgb.c:1551-1588)
            temp = _log_tonemapping(torch.clamp(x, min=NORM_MIN), gs, bs, dr)
            lum = w[0] * temp[0] + w[1] * temp[1] + w[2] * temp[2]
            desaturate = _desaturate_v1 if version == CSCI_V1 \
                else _desaturate_v2
            desat = desaturate(lum, c["sigma_toe"], c["sigma_shoulder"],
                               c["saturation"])
            sat_in = lum[None] + desat[None] * (temp - lum[None])
            return curve(sat_in)

        # filmic_chroma_v2_v3 (filmicrgb.c:1649-1705)
        norm = torch.clamp(_pixel_norm(x, preserve, w), min=NORM_MIN)
        ratios = x / norm[None]
        min_r = torch.amin(ratios, dim=0, keepdim=True)
        ratios = torch.where(min_r < 0.0, ratios - min_r, ratios)
        nlog = _log_tonemapping(norm, gs, bs, dr)
        desat = _desaturate_v2(nlog, c["sigma_toe"], c["sigma_shoulder"],
                               c["saturation"])
        nout = curve(nlog)
        ratios = torch.clamp(ratios + (1.0 - ratios) * (1.0 - desat[None]),
                             min=0.0)
        if version == CSCI_V3:
            nout = nout / torch.clamp(_pixel_norm(ratios, preserve, w),
                                      min=NORM_MIN)
        out = ratios * nout[None]
        # gamut penalty (filmicrgb.c:1697-1704)
        max_pix = torch.amax(out, dim=0, keepdim=True)
        pen_ratios = torch.clamp(ratios + (1.0 - max_pix), min=0.0)
        return torch.where(max_pix > 1.0, pen_ratios * nout[None], out)

    @staticmethod
    def _agx_matrices(raw_version):
        """(inset, outset, input_m, output_m) as nested lists of the
        float32 values, like the JAX version's `.tolist()`."""
        from . import filmic_agx as agx

        inset, outset = agx.prepare_bracket(raw_version)
        input_m, output_m = agx.agx_matrices()
        return (inset.tolist(), outset.tolist(), input_m.tolist(),
                output_m.tolist())

    def _agx(self, x, c, static):
        inset, outset, input_m, output_m = self._agx_matrices(static[4])
        return self._agx_pixel(x, c, static[2:4], inset, outset, input_m,
                               output_m)

    def _agx_pixel(self, x, c, types, inset, outset, input_m, output_m):
        """Per-pixel AgX math on a (3, h, w) tensor (filmic_agx,
        filmicrgb.c:2436-2520)."""
        from . import filmic_agx as agx
        from ..color import matrices as cm
        from ..color.transforms import apply_matrix

        gs, bs, dr = c["grey_source"], c["black_source"], c["dynamic_range"]
        xx = torch.clamp(torch.nan_to_num(x), -1e6, 1e6)
        compressed = agx.compress_negatives(xx, [float(v) for v in cm.WORK_Y])
        Y0, c0, cos0, sin0 = agx.rgb_to_ych(compressed, input_m)

        rendering = apply_matrix(compressed, inset)
        # RGB_tone_mapping_v4 (filmicrgb.c:2113-2128)
        mapped = _log_tonemapping(rendering, gs, bs, dr)
        sp_v = _spline_eval(mapped, types, c)
        rendering = torch.clamp(sp_v, torch.zeros_like(c["y4"]), c["y4"]) \
            ** c["output_power"]
        out_rgb = apply_matrix(rendering, outset)

        Yf, cf, cosf, sinf = agx.rgb_to_ych(out_rgb, input_m)
        chroma_final = torch.minimum(c0, cf)
        beta = c["beta_hue"]
        r_mix = beta * c0 * cos0 + (1.0 - beta) * chroma_final * cosf
        g_mix = beta * c0 * sin0 + (1.0 - beta) * chroma_final * sinf
        norm_mix = torch.sqrt(r_mix ** 2 + g_mix ** 2)
        ref_cos = torch.where(norm_mix > 1e-9,
                              r_mix / torch.clamp(norm_mix, min=1e-20), cos0)
        ref_sin = torch.where(norm_mix > 1e-9,
                              g_mix / torch.clamp(norm_mix, min=1e-20), sin0)
        Y_final = torch.clamp(Yf, agx.CIE_Y_2006 * c["display_black"],
                              agx.CIE_Y_2006 * c["display_white"])
        return agx.gamut_map(Y_final, chroma_final, ref_cos, ref_sin,
                             input_m, output_m, c["display_black"],
                             c["display_white"])

    def _wavelets_reconstruct(self, inp, mask, c, scales: int,
                              rgb_variant: bool):
        """One wavelet reconstruction pass (reconstruct_highlights,
        filmicrgb.c:1408-1509): the a-trous B-spline decompose (two
        sepblur launches a scale); per scale the inpainted high
        frequencies (blurred HF), the raw texture and their achromatic
        syntheses blended under the clip mask."""
        gamma = c["rec_gamma"]
        gamma_c = 1.0 - gamma
        beta = c["rec_beta"]
        beta_c = 1.0 - beta
        delta = c["rec_delta"]
        m = mask[None]
        recon = torch.clamp(inp * (1.0 - m), min=0.0)  # init_reconstruct
        detail = inp
        for s in range(scales):
            LF = torch.clamp(bspline_blur(detail, s), min=0.0)
            texture = detail - LF  # HF backup
            HF = bspline_blur(texture, 0)  # inpaint blur
            # fmaxabsf: the value of the largest |.|, its sign kept
            t0, t1, t2 = texture[0], texture[1], texture[2]
            t01 = torch.where(torch.abs(t0) > torch.abs(t1), t0, t1)
            grey_texture = torch.where(torch.abs(t01) > torch.abs(t2),
                                       t01, t2)
            grey_details = channel_mean(HF)
            if rgb_variant:
                grey_HF = beta_c * (gamma_c * grey_details
                                    + gamma * grey_texture)
                details = (gamma_c * HF + gamma * texture) * beta \
                    + grey_HF[None]
                if s == scales - 1:
                    grey_residual = beta_c * channel_mean(LF)
                    residual = grey_residual[None] + LF * beta
                else:
                    residual = 0.0
            else:
                grey_HF = gamma_c * grey_details + gamma * grey_texture
                details = 0.5 * ((gamma_c * HF + gamma * texture)
                                 + grey_HF[None])
                residual = LF if s == scales - 1 else 0.0
            recon = recon + m * (delta * details + residual)
            detail = LF
        return recon

    def _reconstruct_highlights(self, x, c, rec):
        """Highlight reconstruction before the tone map (filmicrgb.c
        process :2680-2780): the sigmoid clip mask, noise inpainting with
        JAX's generator's normal draw (key 0, `pixel/prng`), the RGB
        wavelet pass and `rec[1]` ratio passes.  The census gate
        (`clipped > 9`, the JAX package's `lax.cond`) reads the count to
        the host: one sync a call, and an unclipped frame pays only the
        norm and the count."""
        norm = torch.sqrt(torch.sum(torch.square(x), dim=0))
        arg = -norm * (c["rec_feather"] / c["rec_threshold"]) \
            + c["rec_feather"]
        mask = torch.clamp(1.0 / (1.0 + torch.exp2(arg)), 0.0, 1.0)
        clipped = int(torch.sum(arg < 4.0))
        if clipped <= 9:
            return x
        scales, hq_iters = rec
        sigma = x * (c["noise_level"] / c["rec_threshold"])
        noise = x + sigma * prng.normal(prng.PRNGKey(0), x.shape, x.device)
        inp = torch.clamp(x * (1.0 - mask[None]) + mask[None] * noise,
                          min=0.0)
        recon = self._wavelets_reconstruct(inp, mask, c, scales, True)
        for _ in range(hq_iters):
            # EUCLIDEAN_NORM_V1: plain sqrt-sum-squares (:991-992)
            norms = torch.clamp(
                torch.sqrt(torch.sum(torch.square(recon), dim=0)),
                min=NORM_MIN)
            ratios = recon / norms[None]
            rr = self._wavelets_reconstruct(ratios, mask, c, scales, False)
            recon = torch.clamp(rr, 0.0, 1.0) * norms[None]
        return recon


# one-stage tone-map chains packed by FilmicRGB.apply, by id of their
# device coefficients (each entry holds the dict, so the id stays its own)
_TONEMAP_CHAINS = {}
