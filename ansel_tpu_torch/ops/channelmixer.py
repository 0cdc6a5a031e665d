"""channelmixer — legacy RGB channel mixer.

Reference: `ansel/src/iop/channelmixer.c` (params v2,
channelmixer.c:120-130): per-destination mixing coefficients; destinations
HUE/SATURATION/LIGHTNESS/R/G/B/GRAY (channelmixer.c:94-112).  Copied from
`ansel_tpu/ops/channelmixer.py`: the RGB and GRAY destinations (the HSL
destinations are legacy GUI aids), as a 3 x 3 mix or one gray row in
plain torch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.params import cfield, params
from ..core.types import Colorspace
from .base import Op, OpPlan, PlanContext, register

CHANNEL_SIZE = 7
CH_RED, CH_GREEN, CH_BLUE, CH_GRAY = 3, 4, 5, 6


@params(op="channelmixer", version=2)
@dataclasses.dataclass
class ChannelMixerParams:
    red: tuple = cfield(f"{CHANNEL_SIZE}f",
                        (0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0))
    green: tuple = cfield(f"{CHANNEL_SIZE}f",
                          (0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0))
    blue: tuple = cfield(f"{CHANNEL_SIZE}f",
                         (0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0))
    algorithm_version: int = cfield("i", 1)


    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        # channelmixer.c v1 {red[7], green[7], blue[7]}: gray slot 6;
        # RGB mixing slots only carried over when gray is unused
        if version == 1:
            v = struct.unpack("<21f", raw[:84])
            red, green, blue = list(v[0:7]), list(v[7:14]), list(v[14:21])
            nr = [red[0], red[1], red[2], 1.0, 0.0, 0.0, red[6]]
            ng = [green[0], green[1], green[2], 0.0, 1.0, 0.0, green[6]]
            nb = [blue[0], blue[1], blue[2], 0.0, 0.0, 1.0, blue[6]]
            if red[6] == 0.0 and green[6] == 0.0 and blue[6] == 0.0:
                for i in range(3):
                    nr[3 + i] = red[3 + i]
                    ng[3 + i] = green[3 + i]
                    nb[3 + i] = blue[3 + i]
            return cls(red=tuple(nr), green=tuple(ng), blue=tuple(nb),
                       algorithm_version=0)
        return None


@register
class ChannelMixer(Op):
    name = "channelmixer"
    input_colorspace = Colorspace.WORK_RGB

    def plan(self, ctx: PlanContext, spec_in, p) -> OpPlan:
        gray = (p.red[CH_GRAY] != 0.0 or p.green[CH_GRAY] != 0.0
                or p.blue[CH_GRAY] != 0.0)
        return OpPlan(spec_in=spec_in, spec_out=spec_in, static=gray)

    def coeffs(self, ctx, plan, p):
        M = np.array([
            [p.red[CH_RED], p.green[CH_RED], p.blue[CH_RED]],
            [p.red[CH_GREEN], p.green[CH_GREEN], p.blue[CH_GREEN]],
            [p.red[CH_BLUE], p.green[CH_BLUE], p.blue[CH_BLUE]],
        ], np.float32)
        gray = np.float32([p.red[CH_GRAY], p.green[CH_GRAY],
                           p.blue[CH_GRAY]])
        return {"M": M, "gray": gray}

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        if plan.static:
            g = torch.tensordot(c["gray"], x, dims=([0], [0]))
            return torch.stack([g, g, g])
        return torch.einsum("dc,chw->dhw", c["M"], x)
