"""colorbalance — legacy lift/gamma/gain and slope/offset/power grading.

Reference: `ansel/src/iop/colorbalance.c` (params v3 :126-134, modes
:88-93), as `ansel_tpu/ops/colorbalance.py` has it: a per-channel CDL in
work RGB, each lift/gamma/gain [master, R, G, B] with the master folded
into the channels; input and output saturation around the luminance and
a contrast around the grey fulcrum.  The mode is the chain stage's
static int: SLOPE_OFFSET_POWER takes the ASC CDL form, the other two
the lift/gamma/gain form.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..color import matrices as cm
from ..color.transforms import fdiv
from ..core.params import cfield, params
from ..core.types import Colorspace
from ..kernels.pointwise import OP_COLORBALANCE
from .base import Op, OpPlan, PlanContext, PointwiseSpec, register

LIFT_GAMMA_GAIN = 0
SLOPE_OFFSET_POWER = 1
LEGACY = 2


@params(op="colorbalance", version=3)
@dataclasses.dataclass
class ColorBalanceParams:
    mode: int = cfield("i", SLOPE_OFFSET_POWER)
    lift: tuple = cfield("4f", (1.0, 1.0, 1.0, 1.0))
    gamma: tuple = cfield("4f", (1.0, 1.0, 1.0, 1.0))
    gain: tuple = cfield("4f", (1.0, 1.0, 1.0, 1.0))
    saturation: float = cfield("f", 1.0)
    contrast: float = cfield("f", 1.0)
    grey: float = cfield("f", 18.0)
    saturation_out: float = cfield("f", 1.0)


    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        # colorbalance.c ladder; mode LEGACY = 0
        if version == 1:  # {lift[4], gamma[4], gain[4]}
            v = struct.unpack("<12f", raw[:48])
            return cls(mode=0, lift=tuple(v[0:4]), gamma=tuple(v[4:8]),
                       gain=tuple(v[8:12]))
        if version == 2:  # + {mode; saturation, contrast, grey}
            v = struct.unpack("<i15f", raw[:64])
            return cls(mode=v[0], lift=tuple(v[1:5]),
                       gamma=tuple(v[5:9]), gain=tuple(v[9:13]),
                       saturation=v[13], contrast=v[14], grey=v[15],
                       saturation_out=1.0)
        return None


def _fold(arr):
    """[master, R, G, B] -> per-channel with master folded
    (reference commit: (v[c]-1) + (v[0]-1) + 1)."""
    return np.float32([(arr[c] - 1.0) + (arr[0] - 1.0) + 1.0
                       for c in (1, 2, 3)])


_CONSTS = ("lift", "gamma", "gain", "saturation", "saturation_out",
           "contrast", "grey", "y")


@register
class ColorBalance(Op):
    name = "colorbalance"
    input_colorspace = Colorspace.WORK_RGB

    def plan(self, ctx: PlanContext, spec_in, p) -> OpPlan:
        return OpPlan(spec_in=spec_in, spec_out=spec_in, static=p.mode)

    def coeffs(self, ctx, plan, p: ColorBalanceParams):
        return {
            "lift": _fold(p.lift), "gamma": _fold(p.gamma),
            "gain": _fold(p.gain),
            "saturation": np.float32(p.saturation),
            "saturation_out": np.float32(p.saturation_out),
            "contrast": np.float32(1.0 / max(p.contrast, 0.01)),
            "grey": np.float32(p.grey / 100.0),
            "y": np.float32(cm.WORK_Y),
        }

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        return _pixel(x, c, plan.static)

    def pointwise_spec(self, plan, ctx):
        mode = plan.static
        return PointwiseSpec(fn=lambda x, c: _pixel(x, c, mode),
                             opcode=OP_COLORBALANCE, consts=_CONSTS,
                             ints=(int(mode),))


def _saturate(x, amount, yw):
    lum = yw[0] * x[0] + yw[1] * x[1] + yw[2] * x[2]
    return lum[None] + amount * (x - lum[None])


def _pixel(x, c, mode):
    yw = c["y"]
    v = torch.clamp(_saturate(x, c["saturation"], yw), min=0.0)
    lift, gamma, gain = c["lift"], c["gamma"], c["gain"]

    def chan(i):
        ig = fdiv(1.0, torch.clamp(gamma[i], min=1e-6))
        if mode == SLOPE_OFFSET_POWER:
            # ASC CDL: (in * slope + offset)^power, with the dt mapping
            # slope = gain, offset = lift - 1, power = gamma inverted
            return torch.clamp(v[i] * gain[i] + (lift[i] - 1.0),
                               min=0.0) ** ig
        # lift gamma gain: gain (in + lift (1 - in)) ^ (1 / gamma)
        return torch.clamp(
            gain[i] * (v[i] + (lift[i] - 1.0) * (1.0 - v[i])), min=0.0) ** ig

    out = torch.stack([chan(i) for i in range(3)])
    # contrast around the grey fulcrum (log-space slope)
    grey = c["grey"]
    out = grey * torch.clamp(out / grey, min=1e-9) ** c["contrast"]
    return _saturate(out, c["saturation_out"], yw)
