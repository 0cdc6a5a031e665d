"""basicadj — black point / exposure / highlight compression / contrast /
brightness / saturation / vibrance in one pass.

Reference: `ansel/src/iop/basicadj.c` (params v2 :72-88, hlcurve :852-880,
process :1282-1420), as `ansel_tpu/ops/basicadj.py` has it: the gamma and
contrast LUTs in closed form.  The chain stage's ints are the five
static switches of `plan.static`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..color import matrices as cm
from ..color.transforms import fdiv
from ..core.params import cfield, params
from ..core.types import Colorspace
from ..kernels.pointwise import OP_BASICADJ
from .base import Op, OpPlan, PlanContext, PointwiseSpec, register

NORM_NONE = 0
NORM_LUMINANCE = 1


@params(op="basicadj", version=2)
@dataclasses.dataclass
class BasicAdjParams:
    black_point: float = cfield("f", 0.0)
    exposure: float = cfield("f", 0.0)
    hlcompr: float = cfield("f", 0.0)
    hlcomprthresh: float = cfield("f", 0.0)
    contrast: float = cfield("f", 0.0)
    preserve_colors: int = cfield("i", NORM_LUMINANCE)
    middle_grey: float = cfield("f", 18.42)
    brightness: float = cfield("f", 0.0)
    saturation: float = cfield("f", 0.0)
    vibrance: float = cfield("f", 0.0)
    clip: float = cfield("f", 0.0)


    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        # basicadj.c v1 = v2 without vibrance (field order differs:
        # v1 has clip last, v2 inserts vibrance before clip)
        if version == 1:
            v = struct.unpack("<5fi4f", raw[:40])
            return cls(black_point=v[0], exposure=v[1], hlcompr=v[2],
                       hlcomprthresh=v[3], contrast=v[4],
                       preserve_colors=v[5], middle_grey=v[6],
                       brightness=v[7], saturation=v[8], vibrance=0.0,
                       clip=v[9])
        return None


_CONSTS = ("black", "scale", "hlcomp", "hlrange", "gamma", "contrast",
           "grey", "saturation", "vibrance", "y")


@register
class BasicAdj(Op):
    name = "basicadj"
    input_colorspace = Colorspace.WORK_RGB

    def plan(self, ctx: PlanContext, spec_in, p: BasicAdjParams) -> OpPlan:
        plain_contrast = (not p.preserve_colors) and p.contrast != 0.0
        preserve = p.preserve_colors if p.contrast != 0.0 else NORM_NONE
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(plain_contrast, preserve,
                              p.brightness != 0.0,
                              p.saturation != 0.0 or p.vibrance != 0.0,
                              p.hlcompr > 0.0))

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: BasicAdjParams):
        white = 2.0 ** p.exposure
        middle_grey = p.middle_grey / 100.0 if p.middle_grey > 0 else 0.1842
        brightness = p.brightness * 2.0
        shoulder = (p.hlcomprthresh / 100.0) / 8.0 + 0.1
        return {
            "black": np.float32(p.black_point),
            "scale": np.float32(1.0 / (white - p.black_point)),
            "hlcomp": np.float32(p.hlcompr / 100.0),
            "hlrange": np.float32(1.0 - shoulder),
            "gamma": np.float32(1.0 / (1.0 + brightness)
                                if brightness >= 0.0 else 1.0 - brightness),
            "contrast": np.float32(p.contrast + 1.0),
            "grey": np.float32(middle_grey),
            "saturation": np.float32(p.saturation + 1.0),
            "vibrance": np.float32(p.vibrance / 1.4),
            "y": np.float32(cm.WORK_Y),
        }

    def apply(self, x, c, plan: OpPlan, ctx):
        return _pixel(x, c, plan.static)

    def pointwise_spec(self, plan, ctx):
        static = plan.static
        return PointwiseSpec(fn=lambda x, c: _pixel(x, c, static),
                             opcode=OP_BASICADJ, consts=_CONSTS,
                             ints=tuple(int(v) for v in static))


def _hlcurve(level, hlcomp, hlrange):
    """basicadj.c:852-880 — log rolloff ratio on luminance."""
    val = level + (hlrange - 1.0)
    val = torch.where(val == 0.0, 1e-6, val)
    Y = torch.clamp(val / hlrange * hlcomp, min=-0.999999)
    R = hlrange / (val * hlcomp)
    return torch.log1p(Y) * R


def _pixel(x, c, static):
    plain_contrast, preserve, has_gamma, has_satvib, has_hl = static
    out = (x - c["black"]) * c["scale"]

    if has_hl:
        y = c["y"]
        lum = y[0] * out[0] + y[1] * out[1] + y[2] * out[2]
        ratio = torch.where(lum > 0.0,
                            _hlcurve(lum, c["hlcomp"], c["hlrange"]), 1.0)
        out = out * ratio[None]

    if has_gamma:
        out = torch.where(out > 0.0,
                          torch.clamp(out, min=0.0) ** c["gamma"], out)
    if plain_contrast:
        ig = 1.0 / c["grey"]
        out = torch.where(
            out > 0.0,
            torch.clamp(out * ig, min=0.0) ** c["contrast"] * c["grey"], out)
    if preserve != NORM_NONE:
        y = c["y"]
        lum = y[0] * out[0] + y[1] * out[1] + y[2] * out[2]
        ig = 1.0 / c["grey"]
        clum = torch.clamp(lum * ig, min=0.0) ** c["contrast"] * c["grey"]
        ratio = torch.where(lum > 0.0,
                            clum / torch.clamp(lum, min=1e-12), 1.0)
        out = out * ratio[None]

    if has_satvib:
        avg = fdiv(out[0] + out[1] + out[2], 3.0)
        delta = torch.sqrt((avg - out[0]) ** 2 + (avg - out[1]) ** 2
                           + (avg - out[2]) ** 2)
        P = c["vibrance"] * (1.0 - torch.clamp(delta, min=0.0)
                             ** torch.abs(c["vibrance"]))
        out = avg[None] + (c["saturation"] + P)[None] * (out - avg[None])
    return out
