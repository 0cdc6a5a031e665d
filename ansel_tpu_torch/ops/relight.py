"""relight — Gaussian-windowed exposure fill-light on L.

Reference: `ansel/src/iop/relight.c` — params v1 (:74-79), process
(:~150-185): gaussian(center, width) of normalized lightness selects the
zone; L is scaled by 2^(ev * gauss).  Copied from
`ansel_tpu/ops/relight.py`, plain torch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.params import cfield, params
from ..core.types import Colorspace
from .base import Op, OpPlan, PlanContext, register


@params(op="relight", version=1)
@dataclasses.dataclass
class RelightParams:
    ev: float = cfield("f", 0.33)
    center: float = cfield("f", 0.0)
    width: float = cfield("f", 4.0)


@register
class Relight(Op):
    name = "relight"
    input_colorspace = Colorspace.LAB

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: RelightParams):
        return {
            "ev": np.float32(p.ev),
            "b": np.float32(-1.0 + p.center * 2.0),
            "c": np.float32((p.width / 10.0) / 2.0),
        }

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        lightness = x[0] / 100.0
        t = -1.0 + lightness * 2.0
        cc = torch.clamp(c["c"], min=1e-9)
        gauss = torch.exp(-((t - c["b"]) ** 2) / (2.0 * cc * cc))
        gauss = torch.clamp(torch.nan_to_num(gauss), 0.0, 1.0)
        relight = torch.pow(2.0, c["ev"] * gauss)
        L = 100.0 * torch.clamp(lightness * relight, 0.0, 1.0)
        return torch.stack([L, x[1], x[2]])
