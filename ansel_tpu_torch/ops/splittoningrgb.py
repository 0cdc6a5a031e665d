"""splittoningrgb — scene-referred RGB split toning: two luminance-keyed
channel-mixer and white-balance matrices, interpolated per pixel.

Reference: `ansel/src/iop/splittoningrgb.c` (params v1 :76-84, the point
transform _build_point_transform :293-313, the per-pixel interpolation
_get_split_matrix :353-377, the keys 2^EV :190-198), as
`ansel_tpu/ops/splittoningrgb.py` has it: below the dark key the matrix
goes from identity to the dark one, above the bright key from identity
to the bright one, between them from dark to bright.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..color import matrices as cm
from ..color.illuminants import blackbody_xy, daylight_xy
from ..core.params import cfield, params
from ..core.types import Colorspace
from ..kernels.pointwise import OP_SPLITTONINGRGB
from .base import Op, OpPlan, PlanContext, PointwiseSpec, register

NORM_MIN = 1.52587890625e-05
NEUTRAL_TEMP = 5003.0  # the reference's pipeline white (D50); the default
# temperature must stay a no-op for XMP interop, so the CAT adapts
# temperature -> 5003K rather than to this pipeline's D65 white


def _temp_lms(temperature: float) -> np.ndarray:
    # daylight locus above 4000K, blackbody below (splittoningrgb.c:200-206)
    x, y = (daylight_xy(temperature) if temperature > 4000.0
            else blackbody_xy(temperature))
    XYZ = cm.xy_to_XYZ(x, y)
    return cm.CAT16 @ (XYZ / max(XYZ[1], 1e-9))


def _point_matrix(red, green, blue, normalize, temperature) -> np.ndarray:
    rows = np.array([red[:3], green[:3], blue[:3]], np.float64)
    for r in range(3):
        if normalize[r]:
            s = rows[r].sum()
            if abs(s) > 1e-9:
                rows[r] = rows[r] / s
    # CAT16 white-balance matrix expressed in work RGB
    # (_build_cat16_rgb_matrix + CAT16_adapt: lms * white / illuminant)
    lms_from_work = cm.CAT16 @ cm.XYZ_D50_TO_D65 @ cm.XYZ_FROM_WORK
    work_from_lms = np.linalg.inv(lms_from_work)
    gain = np.diag(_temp_lms(NEUTRAL_TEMP)
                   / np.maximum(_temp_lms(temperature), 1e-9))
    CAT = work_from_lms @ gain @ lms_from_work
    return (rows @ CAT).astype(np.float32)


@params(op="splittoningrgb", version=1)
@dataclasses.dataclass
class SplitToningRGBParams:
    ev: tuple = cfield("2f", (-4.0, 0.0))
    temperature: tuple = cfield("2f", (5003.0, 5003.0))
    red: tuple = cfield("6f", (1.0, 0.0, 0.0, 1.0, 0.0, 0.0))
    green: tuple = cfield("6f", (0.0, 1.0, 0.0, 0.0, 1.0, 0.0))
    blue: tuple = cfield("6f", (0.0, 0.0, 1.0, 0.0, 0.0, 1.0))
    normalize: tuple = cfield("6i", (0,) * 6)


_CONSTS = ("dark_m", "bright_m", "dark_l", "bright_l", "y")


@register
class SplitToningRGB(Op):
    name = "splittoningrgb"
    input_colorspace = Colorspace.WORK_RGB

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: SplitToningRGBParams):
        mats = []
        for point in range(2):
            sl = slice(3 * point, 3 * point + 3)
            mats.append(_point_matrix(p.red[sl], p.green[sl], p.blue[sl],
                                      p.normalize[sl], p.temperature[point]))
        dark = 2.0 ** p.ev[0]
        bright = 2.0 ** p.ev[1]
        if bright <= dark:
            bright = dark + max(dark * 0.01, 1e-4)
        return {
            "dark_m": mats[0].reshape(-1),
            "bright_m": mats[1].reshape(-1),
            "dark_l": np.float32(dark),
            "bright_l": np.float32(bright),
            "y": np.float32(cm.WORK_Y),
        }

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        return _pixel(x, c)

    def pointwise_spec(self, plan, ctx):
        return PointwiseSpec(fn=_pixel, opcode=OP_SPLITTONINGRGB,
                             consts=_CONSTS)


def _pixel(x, c):
    y = c["y"]
    lum = torch.clamp(y[0] * x[0] + y[1] * x[1] + y[2] * x[2], min=0.0)
    dl, bl = c["dark_l"], c["bright_l"]
    seg = torch.clamp(bl - dl, min=NORM_MIN)
    # zone alphas (_get_split_matrix): identity->dark / dark->bright /
    # identity->bright, selected by luminance
    a_dark = torch.clamp(1.0 - (dl - lum) / seg, 0.0, 1.0)
    a_mid = torch.clamp((lum - dl) / seg, 0.0, 1.0)
    a_bright = torch.clamp(1.0 - (lum - bl) / seg, 0.0, 1.0)
    below = lum <= dl
    above = lum >= bl
    dm, bm = c["dark_m"], c["bright_m"]
    out = []
    for r in range(3):
        acc = None
        for cc in range(3):
            ident = 1.0 if r == cc else 0.0
            d_coef = dm[3 * r + cc]
            b_coef = bm[3 * r + cc]
            m = torch.where(
                below, ident + a_dark * (d_coef - ident),
                torch.where(above, ident + a_bright * (b_coef - ident),
                            d_coef + a_mid * (b_coef - d_coef)))
            term = m * x[cc]
            acc = term if acc is None else acc + term
        out.append(acc)
    return torch.stack(out)
