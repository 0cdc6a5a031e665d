"""colorzones — per-hue L/C/h curves in LCh.

Reference: `ansel/src/iop/colorzones.c` (params v5, colorzones.c:131-141),
as `ansel_tpu/ops/colorzones.py` has it: three curves (lightness,
chroma, hue shift) indexed by the selection channel (hue by default),
node y = 0.5 neutral, smooth mode, strength mixing the effect.  The hue
is `atan2_full`, the Pallas-safe polynomial.  The chain stage's ints are
the selection channel and the three curves' node counts.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..color.transforms import fdiv
from ..core.params import cfield, params
from ..core.types import Colorspace
from ..kernels.pointwise import OP_COLORZONES, atan2_full
from ..pixel import curves
from .base import Op, OpPlan, PlanContext, PointwiseSpec, register

MAXNODES = 20
SELECT_L, SELECT_C, SELECT_H = 0, 1, 2


@params(op="colorzones", version=5)
@dataclasses.dataclass
class ColorZonesParams:
    channel: int = cfield("i", SELECT_H)
    curve: tuple = cfield(
        f"{3 * MAXNODES * 2}f",
        tuple(v for k in range(MAXNODES)
              for v in (k / (MAXNODES - 1.0), 0.5)) * 3,
    )
    curve_num_nodes: tuple = cfield("3i", (2, 2, 2))
    curve_type: tuple = cfield("3i", (2, 2, 2))
    strength: float = cfield("f", 0.0)
    mode: int = cfield("i", 0)
    splines_version: int = cfield("i", 1)


    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        # colorzones.c version ladder (:186-330); CATMULL_ROM = 1,
        # MODE_SMOOTH = 0, SPLINES_V1 = 0, old BANDS = 6 (v1) / 8 (v2+)
        def build(channel, nodes_per_curve, strength=0.0, mode=0):
            curve = []
            for c in range(3):
                pairs = nodes_per_curve[c]
                pairs = pairs + [(0.0, 0.0)] * (MAXNODES - len(pairs))
                for xx, yy in pairs:
                    curve += [xx, yy]
            return cls(channel=channel, curve=tuple(curve),
                       curve_num_nodes=(8, 8, 8),
                       curve_type=(1, 1, 1), strength=strength,
                       mode=mode, splines_version=0)

        if version == 1:  # {channel, x[3][6], y[3][6]} -> 8-node curves
            v = struct.unpack("<i36f", raw[:148])
            ch = v[0]
            xs = [v[1 + c * 6:1 + c * 6 + 6] for c in range(3)]
            ys = [v[19 + c * 6:19 + c * 6 + 6] for c in range(3)]
            curves = []
            for c in range(3):
                pts = [(xs[c][0], ys[c][0])]
                for k in range(6):
                    if k == 0:
                        px = xs[c][k] + 0.001
                    elif k == 5:
                        px = xs[c][k] - 0.001
                    else:
                        px = xs[c][k]
                    pts.append((px, ys[c][k]))
                pts.append((xs[c][5], ys[c][5]))
                curves.append(pts)
            return build(ch, curves)
        if version in (2, 3):  # {channel, x[3][8], y[3][8][, strength]}
            n = 48
            if version == 2:
                v = struct.unpack("<i48f", raw[:196])
                strength = 0.0
            else:
                v = struct.unpack("<i49f", raw[:200])
                strength = v[49]
            ch = v[0]
            xs = [v[1 + c * 8:1 + c * 8 + 8] for c in range(3)]
            ys = [v[25 + c * 8:25 + c * 8 + 8] for c in range(3)]
            curves = [list(zip(xs[c], ys[c])) for c in range(3)]
            return build(ch, curves, strength)
        if version == 4:  # {channel, curve[3][20], nodes, type, strength, mode}
            n = 3 * MAXNODES * 2
            v = struct.unpack(f"<i{n}f6ifi", raw[:4 + n * 4 + 32])
            return cls(channel=v[0], curve=tuple(v[1:1 + n]),
                       curve_num_nodes=tuple(v[1 + n:4 + n]),
                       curve_type=tuple(v[4 + n:7 + n]),
                       strength=v[7 + n], mode=v[8 + n],
                       splines_version=0)
        return None


@register
class ColorZones(Op):
    name = "colorzones"
    input_colorspace = Colorspace.LAB

    def plan(self, ctx: PlanContext, spec_in, p) -> OpPlan:
        nodes = tuple(max(2, min(int(p.curve_num_nodes[ch]), MAXNODES))
                      for ch in range(3))
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(p.channel, nodes))

    def coeffs(self, ctx, plan, p: ColorZonesParams):
        cs = []
        for ch in range(3):
            n = max(2, min(p.curve_num_nodes[ch], MAXNODES))
            base = ch * MAXNODES * 2
            xs = [p.curve[base + 2 * i] for i in range(n)]
            ys = [p.curve[base + 2 * i + 1] for i in range(n)]
            cs.append(curves.curve_coeffs(xs, ys, p.curve_type[ch]))
        return {"c0": cs[0], "c1": cs[1], "c2": cs[2],
                "mix": np.float32(1.0 + p.strength / 100.0)}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        return _pixel(x, c, plan.static[0])

    def pointwise_spec(self, plan, ctx):
        select, nodes = plan.static
        return PointwiseSpec(fn=lambda x, c: _pixel(x, c, select),
                             opcode=OP_COLORZONES,
                             consts=("c0", "c1", "c2", "mix"),
                             ints=(select,) + tuple(nodes))


def _pixel(x, c, select):
    L, a, b = x[0], x[1], x[2]
    C = torch.sqrt(a * a + b * b)
    h = fdiv(atan2_full(b, a), 2.0 * math.pi) + 0.5
    if select == SELECT_L:
        t = torch.clamp(fdiv(L, 100.0), 0.0, 1.0)
    elif select == SELECT_C:
        t = torch.clamp(fdiv(C, 128.0 * math.sqrt(2.0)), 0.0, 1.0)
    else:
        t = h
    sel_L = curves.eval_curve(t, *c["c0"])
    sel_C = curves.eval_curve(t, *c["c1"])
    sel_h = curves.eval_curve(t, *c["c2"])
    mix = c["mix"]
    # y=0.5 neutral; lightness +-50L, chroma x4 range, hue +-30deg
    L2 = L + 100.0 * (sel_L - 0.5) * 2.0 * mix * 0.5
    C2 = C * torch.clamp(2.0 ** (4.0 * (sel_C - 0.5) * mix), min=0.0)
    h2 = h + (sel_h - 0.5) * (60.0 / 360.0) * mix
    ang = (h2 - 0.5) * 2.0 * math.pi
    return torch.stack([torch.clamp(L2, 0.0, 100.0),
                        C2 * torch.cos(ang), C2 * torch.sin(ang)])
