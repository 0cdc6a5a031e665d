"""restorescans — film-scan dye-coupling restoration (CMY unmixing).

Reference: `ansel/src/iop/restorescans.c` (params v1 :34-51; commit_params
:99-112, whose offsets vector is ordered (M_o, C_o, Y_o); process
:140-224: invert to CMY, per iteration a matrix unmix with the offsets
averaged against the running value ((n-1) x + M x) / n, an Oono-Puri
isotropic Laplacian sharpen scaled by diffusion / (scale^2 iterations),
invert back).  A port of `ansel_tpu/ops/restorescans.py` in plain torch
(the JAX package runs it outside any Pallas kernel); the Laplacian's nine
taps are shifted views of `PaddedView`, summed in the same order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.params import cfield, params
from ..core.types import Colorspace
from ..pixel.shifts import PaddedView
from .base import Op, OpPlan, PlanContext, register


@params(op="restorescans", version=1)
@dataclasses.dataclass
class RestoreScansParams:
    C_c: float = cfield("f", 1.0)
    C_m: float = cfield("f", 0.0)
    C_y: float = cfield("f", 0.0)
    C_o: float = cfield("f", 0.0)
    M_c: float = cfield("f", 0.0)
    M_m: float = cfield("f", 1.0)
    M_y: float = cfield("f", 0.0)
    M_o: float = cfield("f", 0.0)
    Y_c: float = cfield("f", 0.0)
    Y_m: float = cfield("f", 0.0)
    Y_y: float = cfield("f", 1.0)
    Y_o: float = cfield("f", 0.0)
    diffusion: float = cfield("f", 0.0)
    regularization: float = cfield("f", 0.0)
    iterations: int = cfield("i", 1)


_LAP = ((0.25, 0.5, 0.25), (0.5, -3.0, 0.5), (0.25, 0.5, 0.25))


@register
class RestoreScans(Op):
    name = "restorescans"
    input_colorspace = Colorspace.WORK_RGB

    def enabled_by_default(self, meta):
        return False

    def plan(self, ctx: PlanContext, spec_in, p) -> OpPlan:
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=max(1, min(int(p.iterations), 32)))

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p):
        return {
            "CMY": np.float32([[p.C_c, p.C_m, p.C_y],
                               [p.M_c, p.M_m, p.M_y],
                               [p.Y_c, p.Y_m, p.Y_y]]),
            # reference quirk: offsets = (M_o, C_o, Y_o)
            "offsets": np.float32([p.M_o, p.C_o, p.Y_o]),
            "diffusion": np.float32(p.diffusion),
        }

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        iters = plan.static
        scale = max(ctx.scale, 1e-3)
        sharpen = c["diffusion"] / (scale * scale) / iters
        cmy = 1.0 - x
        inv_n = 1.0 / iters
        for _ in range(iters):
            t = cmy - c["offsets"].reshape(3, 1, 1)
            mixed = torch.einsum("dc,chw->dhw", c["CMY"], t)
            cmy = torch.clamp(((iters - 1) * cmy + mixed) * inv_n, 0.0, 1.0)
            lap = []
            for ch in range(3):
                pv = PaddedView(cmy[ch], 1)
                acc = None
                for iy, row in enumerate(_LAP):
                    for ix, k in enumerate(row):
                        term = k * pv.at(iy - 1, ix - 1)
                        acc = term if acc is None else acc + term
                lap.append(acc)
            cmy = torch.clamp(cmy - torch.stack(lap) * sharpen, 0.0, 1.0)
        return 1.0 - cmy
