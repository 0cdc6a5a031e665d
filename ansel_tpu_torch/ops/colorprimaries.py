"""colorprimaries — gamut-vertex hue/saturation/brightness editor.

Reference: `ansel/src/iop/colorprimaries.c` (params v1 :88-101:
six edited RGB/CMY gamut vertices recessed by gamut_coverage, smoothing
sigmas; CLUT build _build_clut :704-788 — vertex + edge + radial +
black/white midpoint anchors + no-op axis ladder through the shared
colorrings sparse local field; pixel path process() :931-972:
work/exp2(white_level) -> HLG Rec2020 -> dt_lut3d_apply -> back).

Copied from `ansel_tpu/ops/colorprimaries.py`: the CLUT is built on the
host (`color/colorrings.build_primaries_clut`); the pixels run the matrix,
the HLG transfer and one 3-D LUT interpolation (`ops/lut3d.lut3d_sample`)
in plain torch, as ops/colorequal.py does.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch

from ..color import colorrings as rings
from ..color import matrices as cm
from ..color.transforms import apply_matrix
from ..core.params import cfield, params
from ..core.types import Colorspace
from .base import Op, OpPlan, PlanContext, register

NODES = 6


@params(op="colorprimaries", version=1)
@dataclasses.dataclass
class ColorPrimariesParams:
    white_level: float = cfield("f", 1.0)
    gamut_coverage: float = cfield("f", 67.0)
    sigma_L: float = cfield("f", 100.0)
    sigma_rho: float = cfield("f", 0.70710678)
    sigma_theta: float = cfield("f", 0.70710678)
    neutral_protection: float = cfield("f", 0.0)
    interpolation: int = cfield("i", 0)  # tetrahedral
    hue: tuple = cfield(f"{NODES}f", (0.0,) * NODES)
    saturation: tuple = cfield(f"{NODES}f", (0.0,) * NODES)
    brightness: tuple = cfield(f"{NODES}f", (0.0,) * NODES)

    def is_neutral(self) -> bool:
        return all(abs(v) < 1e-6 for v in
                   tuple(self.hue) + tuple(self.saturation)
                   + tuple(self.brightness))


@register
class ColorPrimaries(Op):
    name = "colorprimaries"
    input_colorspace = Colorspace.WORK_RGB

    def enabled_by_default(self, meta):
        return False

    @staticmethod
    def _signature(p) -> bytes:
        return struct.pack(
            "<6fi", p.white_level, p.gamut_coverage, p.sigma_L,
            p.sigma_rho, p.sigma_theta, p.neutral_protection,
            p.interpolation) \
            + struct.pack(f"<{3 * NODES}f", *p.hue, *p.saturation,
                          *p.brightness)

    def plan(self, ctx: PlanContext, spec_in, p) -> OpPlan:
        if p.is_neutral():
            return OpPlan(spec_in=spec_in, spec_out=spec_in, static=None)
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(p.interpolation, hash(self._signature(p))))

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p):
        if plan.static is None:
            return None
        from .colorequal import cached_clut

        clut = cached_clut((self.name, dataclasses.astuple(p)),
                           lambda: rings.build_primaries_clut(p))
        # white_level is in EV (colorprimaries.c:794: exp2f)
        return {"clut": clut,
                "white": np.float32(max(2.0 ** p.white_level, 1e-6))}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        if plan.static is None:
            return x
        from .colorequal import ColorEqual
        from .lut3d import lut3d_sample

        interp = plan.static[0]
        white = c["white"]
        M = cm.rgb_to_rgb_matrix(cm.WORK_PROFILE, "rec2020").tolist()
        Mi = cm.rgb_to_rgb_matrix("rec2020", cm.WORK_PROFILE).tolist()
        t = apply_matrix(x / white, M)
        code = ColorEqual._hlg_oetf(torch.clamp(t, min=0.0))
        out = lut3d_sample(torch.clamp(code, 0.0, 1.0), c["clut"],
                           rings.CLUT_LEVEL, interp)
        lin = ColorEqual._hlg_eotf(out)
        return apply_matrix(lin, Mi) * white
