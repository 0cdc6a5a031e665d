"""lowlight — scotopic (night) vision.

Reference: `ansel/src/iop/lowlight.c` (params v1 :78-83, process
:~150-210), as `ansel_tpu/ops/lowlight.py` has it: the scotopic
luminance V from XYZ, a blue-shifted scotopic white, and a Catmull-Rom
transition curve over L that blends day and night vision.  The Lab <->
XYZ conversions are the JAX package's (`ansel_tpu/color/transforms.py`:
the cube root as exp(log(r) / 3)) at the D50 pipeline white.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..color.matrices import PIPE_WHITE_XYZ as _WHITE_ARR
from ..color.transforms import LAB_EPS, LAB_KAPPA, fdiv
from ..core.params import cfield, params
from ..core.types import Colorspace
from ..kernels.pointwise import OP_LOWLIGHT
from ..pixel.curves import CATMULL_ROM, curve_coeffs, eval_curve
from .base import Op, OpPlan, PlanContext, PointwiseSpec, register

BANDS = 6
_WHITE = tuple(float(v) for v in _WHITE_ARR)  # D50 Lab white


@params(op="lowlight", version=1)
@dataclasses.dataclass
class LowlightParams:
    blueness: float = cfield("f", 0.0)
    transition_x: tuple = cfield("6f", tuple(k / (BANDS - 1.0)
                                             for k in range(BANDS)))
    transition_y: tuple = cfield("6f", (0.5,) * BANDS)


def lab_to_xyz(lab, white=_WHITE):
    """(3, ...) Lab -> XYZ at `white`, the JAX package's operations."""
    fy = fdiv(lab[0] + 16.0, 116.0)
    fx = fy + fdiv(lab[1], 500.0)
    fz = fy - fdiv(lab[2], 200.0)
    out = []
    for i, f in enumerate((fx, fy, fz)):
        f3 = f * f * f
        r = torch.where(f3 > LAB_EPS, f3, fdiv(116.0 * f - 16.0, LAB_KAPPA))
        out.append(r * white[i])
    return torch.stack(out)


def xyz_to_lab(xyz, white=_WHITE):
    """(3, ...) XYZ at `white` -> Lab, the cube root as exp(log(r) / 3)."""
    f = []
    for i in range(3):
        r = fdiv(xyz[i], white[i])
        croot = torch.exp(torch.log(torch.clamp(r, min=1e-12)) * (1.0 / 3.0))
        f.append(torch.where(r > LAB_EPS, croot,
                             fdiv(LAB_KAPPA * r + 16.0, 116.0)))
    return torch.stack([116.0 * f[1] - 16.0, 500.0 * (f[0] - f[1]),
                        200.0 * (f[1] - f[2])])


@register
class Lowlight(Op):
    name = "lowlight"
    input_colorspace = Colorspace.LAB

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: LowlightParams):
        # periodic-ish end padding like the reference (lowlight.c:218-222)
        xs = ([p.transition_x[BANDS - 2] - 1.0] + list(p.transition_x)
              + [p.transition_x[1] + 1.0])
        ys = [p.transition_y[0]] + list(p.transition_y) \
            + [p.transition_y[BANDS - 1]]
        cx, cy, cmv = curve_coeffs(np.asarray(xs), np.asarray(ys),
                                   CATMULL_ROM)
        # scotopic white: Lab(100, 0, -blueness) -> XYZ, in float32
        sw_lab = torch.tensor([100.0, 0.0, -p.blueness], dtype=torch.float32)
        sw = lab_to_xyz(sw_lab).numpy()
        return {"cx": cx, "cy": cy, "cm": cmv, "sw": sw}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        return _pixel(x, c)

    def pointwise_spec(self, plan, ctx):
        return PointwiseSpec(fn=_pixel, opcode=OP_LOWLIGHT,
                             consts=("cx", "cy", "cm", "sw"),
                             ints=(BANDS + 2,), extra=_WHITE)


def _pixel(x, c):
    xyz = lab_to_xyz(x)
    threshold = 0.01
    denom = torch.clamp(xyz[0], min=threshold)
    V = xyz[1] * (1.33 * (1.0 + (xyz[1] + xyz[2]) / denom) - 1.68)
    V = torch.clamp(0.5 * V, 0.0, 1.0)
    w = torch.clamp(eval_curve(fdiv(x[0], 100.0), c["cx"], c["cy"], c["cm"]),
                    0.0, 1.0)
    sw = c["sw"]
    mixed = torch.stack([w * xyz[i] + (1.0 - w) * V * sw[i]
                         for i in range(3)])
    return xyz_to_lab(mixed)
