"""negadoctor — color/B&W film negative inversion.

Reference: `ansel/src/iop/negadoctor.c` (params v2 :92-113, commit math
:240-268, pixel loop :280-306), as `ansel_tpu/ops/negadoctor.py` has it:
transmission -> density around the Dmin fulcrum, log-space density
correction, paper print (exposure/black/gamma) and the exponential
highlight soft clip.  The JAX package launches `pallas_pointwise` for it
directly on the TPU; here it is a chain stage like any other.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..color.transforms import fdiv
from ..core.params import cfield, params
from ..core.types import Colorspace
from ..kernels.pointwise import OP_NEGADOCTOR
from .base import Op, OpPlan, PlanContext, PointwiseSpec, register

FILMSTOCK_NB = 0
FILMSTOCK_COLOR = 1
THRESHOLD = 2.3283064365386963e-10  # -32 EV
LOG10 = 2.302585092994046


@params(op="negadoctor", version=2)
@dataclasses.dataclass
class NegadoctorParams:
    film_stock: int = cfield("i", FILMSTOCK_COLOR)
    Dmin: tuple = cfield("4f", (1.0, 1.0, 1.0, 1.0))
    wb_high: tuple = cfield("4f", (1.0, 1.0, 1.0, 1.0))
    wb_low: tuple = cfield("4f", (1.0, 1.0, 1.0, 1.0))
    D_max: float = cfield("f", 2.046)
    offset: float = cfield("f", -0.05)
    black: float = cfield("f", 0.0755)
    gamma: float = cfield("f", 4.0)
    soft_clip: float = cfield("f", 0.75)
    exposure: float = cfield("f", 0.9245)


    @classmethod
    def from_legacy(cls, version, raw):
        import struct

        # negadoctor.c v1 = v2 (identical layout, field-by-field copy)
        if version == 1:
            v = struct.unpack("<i12f6f", raw[:76])
            return cls(film_stock=v[0], Dmin=tuple(v[1:5]),
                       wb_high=tuple(v[5:9]), wb_low=tuple(v[9:13]),
                       D_max=v[13], offset=v[14], black=v[15],
                       gamma=v[16], soft_clip=v[17], exposure=v[18])
        return None


_CONSTS = ("Dmin", "wb_high", "offset", "black", "exposure", "gamma",
           "soft_clip", "soft_clip_comp")


@register
class Negadoctor(Op):
    name = "negadoctor"
    input_colorspace = Colorspace.WORK_RGB

    def coeffs(self, ctx: PlanContext, plan: OpPlan, p: NegadoctorParams):
        dmin = list(p.Dmin[:3])
        if p.film_stock == FILMSTOCK_NB:
            dmin = [p.Dmin[0]] * 3
        return {
            "Dmin": np.float32(dmin),
            "wb_high": np.float32([w / p.D_max for w in p.wb_high[:3]]),
            "offset": np.float32([p.wb_high[i] * p.offset * p.wb_low[i]
                                  for i in range(3)]),
            "black": np.float32(-p.exposure * (1.0 + p.black)),
            "exposure": np.float32(p.exposure),
            "gamma": np.float32(p.gamma),
            "soft_clip": np.float32(p.soft_clip),
            "soft_clip_comp": np.float32(1.0 - p.soft_clip),
        }

    def apply(self, x, c, plan: OpPlan, ctx: PlanContext):
        return _pixel(x, c)

    def pointwise_spec(self, plan, ctx):
        return PointwiseSpec(fn=_pixel, opcode=OP_NEGADOCTOR, consts=_CONSTS)


def _pixel(x, c):
    dmin, wbh, off = c["Dmin"], c["wb_high"], c["offset"]
    chans = []
    for i in range(3):
        # transmission -> density with Dmin as fulcrum (negadoctor.c:293)
        density = fdiv(-(torch.log(dmin[i]) - torch.log(
            torch.clamp(x[i], min=THRESHOLD))), LOG10)
        corrected = wbh[i] * density + off[i]
        # print density on paper (negadoctor.c:299-300)
        print_linear = -(c["exposure"] * torch.exp(corrected * LOG10)
                         + c["black"])
        chans.append(torch.clamp(print_linear, min=0.0) ** c["gamma"])
    pg = torch.stack(chans)
    # exponential highlight rolloff (negadoctor.c:303)
    sc, comp = c["soft_clip"], c["soft_clip_comp"]
    soft = sc + (1.0 - torch.exp(-(pg - sc) / comp)) * comp
    return torch.where(pg > sc, soft, pg)
