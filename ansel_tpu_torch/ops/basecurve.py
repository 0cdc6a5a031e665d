"""basecurve — camera-JPEG-style display transform.

Reference: `ansel/src/iop/basecurve.c` (params v6, basecurve.c:110-124), as
`ansel_tpu/ops/basecurve.py` has it: one RGB curve over [0, 1] (unbounded
above) applied through a preserve-colors norm or per channel.  Exposure
fusion is in neither package.  The curve's node count (the chain stage's
second int) rides in `plan.aux`; `plan.static` is the reference's, the
norm alone.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..color import matrices as cm
from ..core.params import cfield, params
from ..core.types import Colorspace
from ..kernels.pointwise import OP_BASECURVE
from ..pixel import curves
from .base import Op, OpPlan, PlanContext, PointwiseSpec, register
from .rgbcurve import rgb_norm

MAXNODES = 20


@params(op="basecurve", version=6)
@dataclasses.dataclass
class BaseCurveParams:
    basecurve: tuple = cfield(
        f"{3 * MAXNODES * 2}f",
        tuple([0.0, 0.0, 1.0, 1.0] + [0.0] * (MAXNODES * 2 - 4)) * 3,
    )
    basecurve_nodes: tuple = cfield("3i", (2, 0, 0))
    basecurve_type: tuple = cfield("3i", (2, 2, 2))
    exposure_fusion: int = cfield("i", 0)
    exposure_stops: float = cfield("f", 1.0)
    exposure_bias: float = cfield("f", 1.0)
    preserve_colors: int = cfield("i", 1)

    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        # basecurve.c version ladder (:170-235); CUBIC_SPLINE = 0,
        # DT_RGB_NORM_NONE = 0
        n = 3 * MAXNODES * 2
        if version == 1:  # {x[6], y[6], preset}
            v = struct.unpack("<12fi", raw[:52])
            xs, ys = v[:6], v[6:12]
            curve = []
            for xx, yy in zip(xs, ys):
                curve += [xx, yy]
            curve += [0.0] * (MAXNODES * 2 - 12)
            curve += ([0.0, 0.0, 1.0, 1.0]
                      + [0.0] * (MAXNODES * 2 - 4)) * 2
            return cls(basecurve=tuple(curve), basecurve_nodes=(6, 3, 3),
                       basecurve_type=(0, 2, 2), exposure_fusion=0,
                       exposure_stops=1.0, exposure_bias=1.0,
                       preserve_colors=0)
        if version == 2:  # {curve, nodes[3], type[3]}
            v = struct.unpack(f"<{n}f6i", raw[:n * 4 + 24])
            return cls(basecurve=tuple(v[:n]),
                       basecurve_nodes=tuple(v[n:n + 3]),
                       basecurve_type=tuple(v[n + 3:n + 6]),
                       exposure_fusion=0, exposure_stops=1.0,
                       exposure_bias=1.0, preserve_colors=0)
        if version in (3, 4):  # + {fusion(i), stops(f)}
            v = struct.unpack(f"<{n}f6fif" if False else f"<{n}f6iif",
                              raw[:n * 4 + 32])
            fusion, stops = v[n + 6], v[n + 7]
            if version == 3 and fusion == 0 and stops == 0:
                stops = 1.0
            return cls(basecurve=tuple(v[:n]),
                       basecurve_nodes=tuple(v[n:n + 3]),
                       basecurve_type=tuple(v[n + 3:n + 6]),
                       exposure_fusion=fusion, exposure_stops=stops,
                       exposure_bias=1.0, preserve_colors=0)
        if version == 5:  # + bias(f)
            v = struct.unpack(f"<{n}f6iff", raw[:n * 4 + 36])
            return cls(basecurve=tuple(v[:n]),
                       basecurve_nodes=tuple(v[n:n + 3]),
                       basecurve_type=tuple(v[n + 3:n + 6]),
                       exposure_fusion=v[n + 6], exposure_stops=v[n + 7],
                       exposure_bias=v[n + 8], preserve_colors=0)
        return None


@register
class BaseCurve(Op):
    name = "basecurve"
    input_colorspace = Colorspace.WORK_RGB

    def plan(self, ctx: PlanContext, spec_in, p) -> OpPlan:
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=p.preserve_colors,
                      aux=max(2, min(p.basecurve_nodes[0], MAXNODES)))

    def coeffs(self, ctx, plan, p: BaseCurveParams):
        n = max(2, min(p.basecurve_nodes[0], MAXNODES))
        xs = [p.basecurve[2 * i] for i in range(n)]
        ys = [p.basecurve[2 * i + 1] for i in range(n)]
        cx, cy, cmv = curves.curve_coeffs(xs, ys, p.basecurve_type[0])
        return {"cx": cx, "cy": cy, "cm": cmv,
                "y_weights": np.float32(cm.WORK_Y)}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        return _pixel(x, c, plan.static)

    def pointwise_spec(self, plan, ctx):
        preserve = plan.static
        return PointwiseSpec(fn=lambda x, c: _pixel(x, c, preserve),
                             opcode=OP_BASECURVE,
                             consts=("cx", "cy", "cm", "y_weights"),
                             ints=(preserve, plan.aux))


def _pixel(x, c, preserve):
    if preserve != 0:
        n = torch.clamp(rgb_norm(x, preserve, c["y_weights"]), min=1e-9)
        mapped = curves.eval_curve(n, c["cx"], c["cy"], c["cm"])
        return x * (mapped / n)[None]
    return curves.eval_curve(x, c["cx"], c["cy"], c["cm"])
