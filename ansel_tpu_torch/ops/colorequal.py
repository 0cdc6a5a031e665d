"""colorequal — dt UCS HSB hue-ring color equalizer.

Reference: `ansel/src/iop/colorequal.c` (params v1 :119-130:
three hue rings × three channels of periodic curves + smoothing sigmas;
CLUT build _build_clut :551-690 — host-side procedural 64³ RGB CLUT in
HLG Rec2020 code values via the Wendland-C2 local displacement field of
`src/pixel/colorequal_shared.c`; pixel path process() :901-945:
work/white_level -> HLG Rec2020 -> dt_lut3d_apply -> back).

Copied from `ansel_tpu/ops/colorequal.py`: the CLUT is built on the
host (`color/colorrings.py`, numpy) at coeffs time, once a process for
each set of params (`cached_clut`); the pixels run the
matrix, the HLG transfer and one 3-D LUT interpolation
(`ops/lut3d.lut3d_sample`) in plain torch.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch

from ..color import colorrings as rings
from ..color import matrices as cm
from ..color.transforms import apply_matrix, fdiv
from ..core.params import cfield, params
from ..core.types import Colorspace
from .base import Op, OpPlan, PlanContext, register

NUM_RINGS = 3
NUM_CHANNELS = 3
MAXNODES = 20

# the CLUTs built in this process, by (op, params as the builder reads
# them: float64 values, not the plan's float32 signature, since a default
# param and its float32 sidecar copy build different CLUTs): a 64^3 build
# takes seconds on the host, and a pipe's coefficients are asked for more
# than once (planning, compiling, an export of the same edit)
_CLUTS = {}


def cached_clut(key, build):
    """The host CLUT for `key`, built once (the last four kept); callers
    must not write to it."""
    clut = _CLUTS.get(key)
    if clut is None:
        clut = _CLUTS[key] = build()
        while len(_CLUTS) > 4:
            del _CLUTS[next(iter(_CLUTS))]
    return clut


@params(op="colorequal", version=1)
@dataclasses.dataclass
class ColorEqualParams:
    white_level: float = cfield("f", 1.0)
    sigma_L: float = cfield("f", 50.0)
    sigma_rho: float = cfield("f", 1.0)
    sigma_theta: float = cfield("f", 0.40)
    neutral_protection: float = cfield("f", 0.05)
    interpolation: int = cfield("i", 0)  # tetrahedral
    curve: tuple = cfield(f"{NUM_RINGS * NUM_CHANNELS * MAXNODES * 2}f",
                          (0.0,) * (NUM_RINGS * NUM_CHANNELS * MAXNODES * 2))
    curve_num_nodes: tuple = cfield(f"{NUM_RINGS * NUM_CHANNELS}i",
                                    (0,) * (NUM_RINGS * NUM_CHANNELS))

    def nodes(self, ring: int, channel: int):
        n = int(self.curve_num_nodes[ring * NUM_CHANNELS + channel])
        base = (ring * NUM_CHANNELS + channel) * MAXNODES * 2
        return [(self.curve[base + 2 * k], self.curve[base + 2 * k + 1])
                for k in range(max(0, min(n, MAXNODES)))]

    def is_neutral(self) -> bool:
        for ring in range(NUM_RINGS):
            for ch in range(NUM_CHANNELS):
                for _x, y in self.nodes(ring, ch):
                    if abs(y - 0.5) > 1e-6:
                        return False
        return True


@register
class ColorEqual(Op):
    name = "colorequal"
    input_colorspace = Colorspace.WORK_RGB

    def enabled_by_default(self, meta):
        return False

    @staticmethod
    def _signature(p: ColorEqualParams) -> bytes:
        return struct.pack(
            "<5fi", p.white_level, p.sigma_L, p.sigma_rho, p.sigma_theta,
            p.neutral_protection, p.interpolation) \
            + struct.pack(f"<{len(p.curve)}f", *p.curve) \
            + struct.pack(f"<{len(p.curve_num_nodes)}i", *p.curve_num_nodes)

    def plan(self, ctx: PlanContext, spec_in, p: ColorEqualParams) -> OpPlan:
        if p.is_neutral():
            return OpPlan(spec_in=spec_in, spec_out=spec_in, static=None)
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(p.interpolation, hash(self._signature(p))))

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: ColorEqualParams):
        if plan.static is None:
            return None
        clut = cached_clut((self.name, dataclasses.astuple(p)),
                           lambda: rings.build_clut(p))
        # white_level is in EV (colorequal.c:794: exp2f)
        return {"clut": clut,
                "white": np.float32(max(2.0 ** p.white_level, 1e-6))}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        if plan.static is None:
            return x
        from .lut3d import lut3d_sample

        interp = plan.static[0]
        white = c["white"]
        # work -> linear Rec2020 (identity when work == rec2020) -> HLG code
        M = cm.rgb_to_rgb_matrix(cm.WORK_PROFILE, "rec2020").tolist()
        Mi = cm.rgb_to_rgb_matrix("rec2020", cm.WORK_PROFILE).tolist()
        t = apply_matrix(x / white, M)
        code = self._hlg_oetf(torch.clamp(t, min=0.0))
        out = lut3d_sample(torch.clamp(code, 0.0, 1.0), c["clut"],
                           rings.CLUT_LEVEL, interp)
        lin = self._hlg_eotf(out)
        return apply_matrix(lin, Mi) * white

    @staticmethod
    def _hlg_oetf(e):
        A, B, C = 0.17883277, 0.28466892, 0.55991073
        return torch.where(e <= 1.0 / 12.0, torch.sqrt(3.0 * e),
                           A * torch.log(torch.clamp(12.0 * e - B,
                                                     min=1e-12)) + C)

    @staticmethod
    def _hlg_eotf(code):
        A, B, C = 0.17883277, 0.28466892, 0.55991073
        return torch.where(code <= 0.5, fdiv(code * code, 3.0),
                           fdiv(torch.exp(fdiv(code - C, A)) + B, 12.0))
