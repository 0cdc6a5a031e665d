"""bilat — "local contrast" (local Laplacian or bilateral grid).

Reference: `ansel/src/iop/bilat.c` (params v3, bilat.c:78-86).  Planning
is copied from `ansel_tpu/ops/bilat.py`.  Mode 1 (the default) runs the
local Laplacian on Lab L (`pixel/locallaplacian.py`) with shadows =
sigma_s / 100, highlights = sigma_r / 100, clarity = detail and the
midtone as its sigma.  Mode 0 runs the bilateral grid on L
(`pixel/bilateralgrid.grid_filter`, src/pixel/bilateral.c) with the
detail-boost slicing of dt_bilateral_slice_to_output:
out = in + detail * (in - base).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.params import cfield, params
from ..core.types import Colorspace
from ..pixel.bilateralgrid import grid_filter
from ..pixel.locallaplacian import local_laplacian
from .base import Op, OpPlan, PlanContext, register

# dt_iop_bilat_mode_t (bilat.c:71-75): 0 = bilateral grid, 1 = local
# laplacian; default mode is 1 (bilat.c:80)
MODE_BILATERAL = 0
MODE_LOCAL_LAPLACIAN = 1


@params(op="bilat", version=3)
@dataclasses.dataclass
class BilatParams:
    mode: int = cfield("I", MODE_LOCAL_LAPLACIAN)
    sigma_r: float = cfield("f", 0.5)
    sigma_s: float = cfield("f", 0.5)
    detail: float = cfield("f", 0.25)
    midtone: float = cfield("f", 0.5)

    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        # bilat.c ladder (:151-178): v1 grid-only, v2 adds mode;
        # both map to midtone 0.2
        if version == 1:
            sr, ss, det = struct.unpack("<3f", raw[:12])
            return cls(mode=MODE_BILATERAL, sigma_r=sr, sigma_s=ss,
                       detail=det, midtone=0.2)
        if version == 2:
            m, sr, ss, det = struct.unpack("<I3f", raw[:16])
            return cls(mode=m, sigma_r=sr, sigma_s=ss, detail=det,
                       midtone=0.2)
        return None


@register
class Bilat(Op):
    name = "bilat"
    input_colorspace = Colorspace.LAB

    def plan(self, ctx: PlanContext, spec_in, p: BilatParams) -> OpPlan:
        return OpPlan(spec_in=spec_in, spec_out=spec_in,
                      static=(p.mode, round(max(p.midtone, 1e-3), 5),
                              round(p.sigma_s, 4), round(p.sigma_r, 4),
                              round(p.detail, 4)))

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        mode, midtone, sigma_s, sigma_r, detail = plan.static
        if mode == MODE_BILATERAL:
            L = grid_filter(x[0], x[0:1], max(sigma_s * ctx.scale, 1.0),
                            max(sigma_r, 1.0), 0.0, 100.0, detail=detail)[0]
            return torch.stack([torch.clamp(L, min=0.0), x[1], x[2]])
        L = local_laplacian(x[0] / 100.0, midtone, sigma_s / 100.0,
                            sigma_r / 100.0, detail)
        return torch.stack([torch.clamp(L * 100.0, min=0.0), x[1], x[2]])
