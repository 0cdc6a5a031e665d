"""tonecurve — Lab tone curves.

Reference: `ansel/src/iop/tonecurve.c` (params v5, tonecurve.c:187-197),
as `ansel_tpu/ops/tonecurve.py` has it: the L curve over [0, 100] with
unbounded extrapolation, a and b scaled by the L ratio.  The curve's node
count (the chain stage's int) rides in `plan.aux`; `plan.static` is the
reference's, the autoscale flag.
"""

from __future__ import annotations

import dataclasses

import torch

from ..color.transforms import fdiv
from ..core.params import cfield, params
from ..core.types import Colorspace
from ..kernels.pointwise import OP_TONECURVE
from ..pixel import curves
from .base import Op, OpPlan, PlanContext, PointwiseSpec, register

MAXNODES = 20
AUTOSCALE_RGB = 0   # "Lab, linked" in dt terms
MANUAL = 1


@params(op="tonecurve", version=5)
@dataclasses.dataclass
class ToneCurveParams:
    tonecurve: tuple = cfield(
        f"{3 * MAXNODES * 2}f",
        tuple([0.0, 0.0, 1.0, 1.0] + [0.0] * (MAXNODES * 2 - 4)) * 3,
    )
    tonecurve_nodes: tuple = cfield("3i", (2, 3, 3))
    tonecurve_type: tuple = cfield("3i", (2, 2, 2))
    tonecurve_autoscale_ab: int = cfield("i", 0)
    tonecurve_preset: int = cfield("i", 0)
    tonecurve_unbound_ab: int = cfield("i", 1)
    preserve_colors: int = cfield("i", 3)


    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        # tonecurve.c version ladder (:273-331); CUBIC_SPLINE = 0
        def flat(curves):
            out = []
            for nodes in curves:
                pairs = list(nodes) + [(0.0, 0.0)] * (MAXNODES - len(nodes))
                for xx, yy in pairs:
                    out += [xx, yy]
            return tuple(out)

        if version == 1:  # {x[6], y[6], preset}
            v = struct.unpack("<12fi", raw[:52])
            xs, ys, preset = v[:6], v[6:12], v[12]
            curves = [list(zip(xs, ys)),
                      [(0.0, 0.0), (0.5, 0.5), (1.0, 1.0)],
                      [(0.0, 0.0), (0.5, 0.5), (1.0, 1.0)]]
            return cls(tonecurve=flat(curves), tonecurve_nodes=(6, 3, 3),
                       tonecurve_type=(0, 2, 2), tonecurve_autoscale_ab=1,
                       tonecurve_preset=preset, tonecurve_unbound_ab=0,
                       preserve_colors=0)
        if version in (3, 4):
            n = 3 * MAXNODES * 2
            fmt = f"<{n}f8i" if version == 3 else f"<{n}f9i"
            sz = n * 4 + (32 if version == 3 else 36)
            v = struct.unpack(fmt, raw[:sz])
            curve = tuple(v[:n])
            ints = v[n:]
            return cls(tonecurve=curve, tonecurve_nodes=tuple(ints[0:3]),
                       tonecurve_type=tuple(ints[3:6]),
                       tonecurve_autoscale_ab=ints[6],
                       tonecurve_preset=ints[7],
                       tonecurve_unbound_ab=(ints[8] if version == 4
                                             else 0),
                       preserve_colors=0)
        return None


@register
class ToneCurve(Op):
    name = "tonecurve"
    input_colorspace = Colorspace.LAB

    def plan(self, ctx: PlanContext, spec_in, p) -> OpPlan:
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=p.tonecurve_autoscale_ab,
                      aux=max(2, min(p.tonecurve_nodes[0], MAXNODES)))

    def coeffs(self, ctx, plan, p: ToneCurveParams):
        n = max(2, min(p.tonecurve_nodes[0], MAXNODES))
        xs = [p.tonecurve[2 * i] for i in range(n)]
        ys = [p.tonecurve[2 * i + 1] for i in range(n)]
        cx, cy, cm = curves.curve_coeffs(xs, ys, p.tonecurve_type[0])
        return {"cx": cx, "cy": cy, "cm": cm}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        return _pixel(x, c)

    def pointwise_spec(self, plan, ctx):
        return PointwiseSpec(fn=_pixel, opcode=OP_TONECURVE,
                             consts=("cx", "cy", "cm"), ints=(plan.aux,))


def _pixel(x, c):
    L = fdiv(x[0], 100.0)
    L_out = curves.eval_curve(L, c["cx"], c["cy"], c["cm"]) * 100.0
    # automatic ab: scale chroma with the L ratio
    ratio = L_out / torch.clamp(x[0], min=1e-6)
    return torch.stack([L_out, x[1] * ratio, x[2] * ratio])
