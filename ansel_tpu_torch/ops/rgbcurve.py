"""rgbcurve — RGB tone curves (linked or per-channel) with color
preservation norms.

Reference: `ansel/src/iop/rgbcurve.c` (params v1, rgbcurve.c:94-109), as
`ansel_tpu/ops/rgbcurve.py` has it: up to 20 (x, y) nodes per channel,
three interpolators (common/curve_tools.c); linked mode applies curve 0
through a chosen RGB norm (src/pixel/rgb_norms.h) preserving ratios,
independent mode each channel's curve.  Above the last node the curve
continues linearly.  The chain stage's ints are the autoscale mode, the
norm and the three curves' node counts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..color import matrices as cm
from ..color.transforms import fdiv
from ..core.params import cfield, params
from ..core.types import Colorspace
from ..kernels.pointwise import OP_RGBCURVE
from ..pixel import curves
from .base import Op, OpPlan, PlanContext, PointwiseSpec, register

MAXNODES = 20
SCALE_AUTOMATIC_RGB = 0
SCALE_MANUAL_RGB = 1

(NORM_NONE, NORM_LUMINANCE, NORM_MAX, NORM_AVERAGE, NORM_SUM, NORM_NORM,
 NORM_POWER) = range(7)

@params(op="rgbcurve", version=1)
@dataclasses.dataclass
class RGBCurveParams:
    # interleaved (x, y) pairs: 3 channels x 20 nodes x 2 floats
    curve_nodes: tuple = cfield(
        f"{3 * MAXNODES * 2}f",
        tuple([0.0, 0.0, 1.0, 1.0] + [0.0] * (MAXNODES * 2 - 4)) * 3,
    )
    curve_num_nodes: tuple = cfield("3i", (2, 2, 2))
    curve_type: tuple = cfield("3i", (2, 2, 2))  # MONOTONE_HERMITE
    curve_autoscale: int = cfield("i", SCALE_AUTOMATIC_RGB)
    compensate_middle_grey: int = cfield("i", 0)
    preserve_colors: int = cfield("i", NORM_LUMINANCE)


def rgb_norm(x: torch.Tensor, kind: int, y_weights) -> torch.Tensor:
    """The preserve-colors norm of (3, H, W) -> (H, W), each sum taken
    channel by channel in order."""
    if kind == NORM_LUMINANCE:
        w = y_weights
        return w[0] * x[0] + w[1] * x[1] + w[2] * x[2]
    if kind == NORM_AVERAGE:
        return fdiv(x[0] + x[1] + x[2], 3.0)
    if kind == NORM_SUM:
        return x[0] + x[1] + x[2]
    if kind == NORM_NORM:
        return torch.sqrt(x[0] * x[0] + x[1] * x[1] + x[2] * x[2])
    if kind == NORM_POWER:
        a = torch.abs(x)
        return (a[0] ** 3 + a[1] ** 3 + a[2] ** 3) / torch.clamp(
            a[0] ** 2 + a[1] ** 2 + a[2] ** 2, min=1e-12)
    # NORM_MAX and any other value
    return torch.maximum(torch.maximum(x[0], x[1]), x[2])


def _nodes(p: RGBCurveParams, ch: int):
    n = max(2, min(int(p.curve_num_nodes[ch]), MAXNODES))
    base = ch * MAXNODES * 2
    xs = [p.curve_nodes[base + 2 * i] for i in range(n)]
    ys = [p.curve_nodes[base + 2 * i + 1] for i in range(n)]
    return xs, ys


@register
class RGBCurve(Op):
    name = "rgbcurve"
    input_colorspace = Colorspace.WORK_RGB

    def plan(self, ctx: PlanContext, spec_in, p: RGBCurveParams) -> OpPlan:
        nodes = tuple(max(2, min(int(p.curve_num_nodes[ch]), MAXNODES))
                      for ch in range(3))
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(p.curve_autoscale, p.preserve_colors, nodes))

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: RGBCurveParams):
        cs = [curves.curve_coeffs(*_nodes(p, ch), p.curve_type[ch])
              for ch in range(3)]
        return {"c0": cs[0], "c1": cs[1], "c2": cs[2],
                "y_weights": np.float32(cm.WORK_Y)}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        return _pixel(x, c, *plan.static[:2])

    def pointwise_spec(self, plan, ctx):
        autoscale, preserve, nodes = plan.static
        return PointwiseSpec(
            fn=lambda x, c: _pixel(x, c, autoscale, preserve),
            opcode=OP_RGBCURVE, consts=("c0", "c1", "c2", "y_weights"),
            ints=(autoscale, preserve) + tuple(nodes))


def _pixel(x, c, autoscale, preserve):
    if autoscale == SCALE_AUTOMATIC_RGB and preserve != NORM_NONE:
        ratio_src = torch.clamp(rgb_norm(x, preserve, c["y_weights"]),
                                min=1e-9)
        mapped = curves.eval_curve(ratio_src, *c["c0"])
        return x * (mapped / ratio_src)[None]
    if autoscale == SCALE_AUTOMATIC_RGB:
        return curves.eval_curve(x, *c["c0"])
    return torch.stack([curves.eval_curve(x[i], *c[f"c{i}"])
                        for i in range(3)])
